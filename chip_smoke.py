"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: builds the port's CUDA kernels, holds each against its plain PyTorch
version, drives the image lane (and its arena bench), the dense Qwen3-4B
serving path, the Grok-1 and Kimi-K2 MoE serving paths, the Hymba-1.5B,
xLSTM-350M and Whisper-tiny serving paths, the Qwen3-14B, Yi-34B,
StableLM-2-1.6B and InternVL2-2B serving paths, the reference's
prefill_32k and decode_32k cells of all ten and long_500k of Hymba-1.5B
and xLSTM-350M, the Qwen3-4B, Grok-1,
Hymba-1.5B, xLSTM-350M and Whisper-tiny training paths (Grok-1 also on
int8 AdamW moments, with the state restored onto a device mesh) and the
1000-host multi-host loader end to
end, times the kernels, and holds the dry run's counts against the card.
The f32 checks' CPU sides run in two worker processes beside the card's
phases; each is collected when it is ready, and all before phase H.

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
     (the reference's kernel sweeps with head dim 112 and G = 5 added, and
     non-causal attention with S != T, 2e-5 in f32, 2e-2 in bf16; every
     serving path's shapes, Kimi-K2's at head dim 112, Hymba's windowed
     prefill and ring and Whisper-tiny's encoder, decoder and
     cross-attention included, 2e-5 in f32, and in bf16 2**-6 rtol plus
     2**-5 of each output row's RMS; bf16 decode also at the engine's live
     length and at ragged lengths that hit each tile and split boundary;
     two bf16 decode launches at decode_32k and at the dense serving shape
     give the same bits; phases L-O's prefill, decode and f32 check shapes
     (G = 5, 7, 1 over 32 kv heads at D = 64, and 2); each 32k cell's
     attention (``FLASH_32K_CASES``), held one kv group at a time on the
     first and the last group, and its decode at its batch
     (``DECODE_32K_CASES``) at lengths 1, T // 3, T and ragged); then the
     other families' cells the same way (``FLASH_32K_FAMILY_CASES``:
     Kimi-K2 at G = 8 and D = 112, its plain version in pieces of 4 query
     heads, Hymba's window, Whisper's decoder and its cross-attention over
     1500 frames; ``DECODE_32K_FAMILY_CASES``: Kimi-K2 and Whisper at 128
     slots, Hymba's ring at 128 slots and at long_500k's one);
  7. the serving path at full width: Qwen3-4B (36 layers, bf16, seeded
     random weights), prompts fetched over the simulated WAN by
     ``build_stack``, a 4 x 2048 prefill and continuous-batching decode of
     16 prompts, with the kernels' launches counted; then, on the same
     weights, the prefill_32k and decode_32k cells (``drive_cells``: one
     row of 32,768 tokens, two calls; 4 serve steps from a seeded cache of
     32,768 tokens at its batch of ``DECODE_32K_BATCH``, the last over
     every key), each with exact launches, its ms, peak memory and cuts;
  8. the same path in f32 at 2 layers on the card and on the CPU (the
     kernels' plain versions, in an f32 worker process, on the card's
     weights shipped as numpy): prefill and decode logits within 1e-3;
  9. the attention kernels' times at every bf16 path shape (Qwen3-4B's,
     Grok-1's, Kimi-K2's, Hymba's and Whisper-tiny's, each with its mask)
     against their bounds, plain versions and
     ``scaled_dot_product_attention``; flash attention at three 32k shapes
     (Qwen3-4B's prefill_32k, G = 7, and D = 64 over 32 kv heads); flash
     decode also at the engine's live lengths and at each decode_32k
     cell's shape (the other families' too), and beside the CUDA-core
     decode kernel in bf16; the other families' 32k attention
     (``TIME_ATTENTION_32K_FAMILY``; SDPA takes Hymba's window as a mask
     over repeated kv heads); f32
     flash decode at the dense serving shape beside SDPA in f32;
 10. grouped matmul == its plain version on the card: the reference's
     sweep, ragged and unaligned edges and strided views (f32 1e-4; bf16
     5e-2 rtol / 5e-1 atol), and every shape of the Grok-1 and Kimi-K2
     MoE paths (Grok-1's prefill_32k chunk and decode_32k step among
     them), and a prefill chunk off them (bf16 within two ulps,
     2**-6 rtol / 1e-3 atol; f32 1e-4); two launches at Grok-1's and
     Kimi-K2's decode down projections give the same bits; Kimi-K2's
     cells' chunk of one row (C = 14) and step of 128 slots (C = 128);
 11. the MoE serving path at full width: Grok-1 (4 of its 64 layers, bf16,
     seeded random weights), prompts fetched over the simulated WAN, a
     2 x 2048 prefill and continuous-batching decode of 16 prompts, with
     the kernels' launches counted (the Qwen3-4B phases' tensors are freed
     first), then its 32k cells as phase 7's (prefill_32k's 64 MoE chunks:
     3 x 4 x 64 grouped-matmul launches a call);
 12. the same path in f32 at 2 layers and d_ff 2048 on the card and on the
     CPU: prefill and decode logits within 1e-3;
 13. Kimi-K2 serving at full width (1 of its 61 layers, head dim 112, 384
     experts, bf16, seeded random weights; Grok-1's tensors freed first):
     a 2 x 2048 prefill and continuous-batching decode of 8 prompts, with
     the kernels' launches counted, then its prefill_32k and decode_32k
     cells as phase 7's (decode_32k at the reference's 128 slots: 36.4 GB
     of weights and 15 GB of cache), then the same path in f32 at d_ff
     256 on the card and on the CPU (logits within 1e-3);
  D. Hymba-1.5B serving at full width and depth (32 layers, 25 query heads
     over 5 kv heads, a 1024-token window, bf16, seeded random weights;
     Kimi-K2's tensors freed first): prompts over the simulated WAN, a
     4 x 2048 prefill and continuous-batching decode of 16 prompts over a
     1024-slot ring, with exactly 32 flash-attention launches per prefill
     call and 32 flash-decode launches per engine step; then the same path
     in f32 at 2 layers on the card and on the CPU, its decode on one slot
     past the window (a 1050-token prompt, 16 new tokens): logits within
     1e-3;
  E. xLSTM-350M serving at full width and depth (24 layers), a 2 x 2048
     prefill and 16 prompts through the engine, with no kernel launch at
     all (its cells are plain torch, as the reference's are XLA ops), and
     the f32 check at 2 layers;
  F. Whisper-tiny serving at full width and depth (4 encoder and 4 decoder
     layers): an 8 x 448 prefill with (8, 1500, 384) frames and 16 prompts
     through the engine over a 448-token cache, with exactly 12
     flash-attention launches per prefill call (4 encoder, 4 self, 4
     cross) and 8 flash-decode launches per engine step (4 self, 4 cross
     over the 1500 frames), and the f32 check of the whole model; each of
     D, E and F runs its cells on its weights before its f32 check
     (``drive_cells``, ``cell_sizes``): prefill_32k (Hymba whole, xLSTM at
     its first mLSTM/sLSTM pair, Whisper's decoder at 32,768 positions
     over make_batch's (1, 1500, 384) frames), decode_32k at 128 slots
     and, for Hymba and xLSTM, long_500k (one slot, 4 steps ending at
     position 524,287); a recurrent state (Hymba's Mamba state, xLSTM's
     states) is brought by ``WARM_STEPS`` serve steps before K and V are
     drawn and the position set (``seed_cache``); each prints its
     seconds;
  L, M, N, O. Qwen3-14B (whole: 40 layers, G = 5), Yi-34B (30 of its 60
     layers: whole, its bf16 weights leave no room for a 32k cache; G =
     7), StableLM-2-1.6B (whole, 32 kv heads at D = 64) and InternVL2-2B
     (whole, G = 2, with 256 patch embeddings) served at full width as
     phase 13 (8 prompts of 64 tokens over the simulated WAN, a 2 x 2048
     prefill, 8 slots over a 1024-token cache, 16 new tokens), with
     exactly L flash-attention launches per prefill call and L
     flash-decode launches per engine step, then each config's 32k cells
     as phase 7's, then the f32 check at 2 layers on the card and on the
     CPU (InternVL2's on 512 tokens, past its patches): logits within
     1e-3; each prints its depth, its decode_32k batch and its seconds;
 14. the training path at full width and depth: Qwen3-4B (36 layers,
     bf16, remat, seeded random weights; phase F's tensors freed first),
     token records fetched over the simulated WAN by ``build_stack``'s
     DeviceFeed, 3 steps of ``run_training`` (AdamW) at 2 x 4096 tokens,
     with ms per step (step 2's: the 3rd runs under
     ``FlopCounterMode`` for phase H), tokens/s, peak memory, each step's
     loss and grad norm, stall and goodput, and a derived share of the
     bf16 peak; it
     raises on a loss or norm that is not finite, unchanged parameters,
     missing steps or any kernel launch (training runs none);
 15. the train step in f32 at 2 layers, full width, 1 x 256 tokens, on
     the card and on the CPU from one state: the first step's gradients
     and 3 steps' losses within 1e-3; then a restart from a checkpoint on
     the card (the quickstart config) against the run without a stop;
  C. the MoE training path at full width: Grok-1 (1 of its 64 layers, all
     8 experts, top-2, bf16, f32 AdamW moments, remat, seeded random
     weights; the earlier phases' tensors freed first), token records
     fetched over the simulated WAN by ``build_stack``'s DeviceFeed, 3
     steps of ``run_training`` at 2 x 2048 tokens (four 512-token chunks a
     row, each under its checkpoint), with ms per step, tokens/s, peak
     memory, the losses and MoE metrics, the stall share and a derived
     share of the bf16 peak over the active parameters; it raises as phase
     14 does (the router and an expert weight must change; training
     launches no kernel: its experts are the reference's einsums); then
     the train step in f32 at 1 layer, d_ff 256 and vocabulary 32768 on
     1 x 1024 tokens (two chunks) on the card and on the CPU, as phase 15
     (no restart); then,
     on the card, the trained f32 model's training forward (einsums)
     against its serving forward (the f32 grouped-matmul and
     flash-attention kernels): logits within 1e-3 and exactly
     3 x layers x chunks grouped-matmul launches;
  G. the int8 training path at full width: Grok-1 (2 of its 64 layers,
     bf16, remat, AdamW with int8 m and v, the reference's memory policy
     for Grok-1; the earlier phases' tensors freed first), 3 steps of
     ``run_training`` at 2 x 2048 tokens as phase C, printing the same
     numbers and raising as phase 14 does; then phase C's f32 check (1
     layer, d_ff 256, vocabulary 32768, 3 steps, card against CPU) on
     1 x 512 tokens (one chunk) for
     ``int8`` and ``int8_factored``, with the moments after the first
     update held too (each int8 value within one quantization step of
     its row plus 1e-3 of its leaf's max, each f32 moment within 1e-3);
     then, on a
     one-rank NCCL group, the int8 state saved and restored with
     ``shardings`` onto a 1 x 1 ``DeviceMesh`` (every leaf a DTensor on
     the card, bit-exact) and ``compressed_psum_grads`` on the first
     step's gradients equal to the CPU port's over gloo; no kernel
     launches; it prints its seconds;
  I. the hybrid training path at full width: Hymba-1.5B (16 of its 32
     layers, 25 query heads over 5 kv heads, a 1024-token window, Mamba
     d_inner 1600 and state 16; bf16, remat, f32 AdamW moments, seeded
     random weights; the earlier phases' tensors freed first), 3 steps of
     ``run_training`` at 2 x 4096 tokens over the simulated WAN as phase
     14, printing and raising as phase 14 does (a Mamba weight must move
     beside the attention's and the MLP's); then the train step in f32 at
     2 layers, full width, on 1 x 2080 tokens (chunked attention past the
     window, 9 Mamba chunks, the last ragged), card against CPU as phase
     15 without the restart;
  J. the SSM training path at full width: xLSTM-350M (4 of its 24
     layers, 2 mLSTM/sLSTM pairs), 1 step of ``run_training`` at 2 x
     4096 tokens (timed, warm-up included; the sLSTM walks 4096 steps a
     layer three times a step), with the derived ms per sLSTM step and
     layer; the sLSTM's and the mLSTM's weights must move; then the f32
     check at one pair on 1 x 544 tokens (three mLSTM chunks, the last
     ragged);
  K. the audio training path at full width and depth: Whisper-tiny (4
     encoder and 4 decoder layers), 8 steps of ``make_train_step`` on 2 x
     4096 tokens fetched over the simulated WAN with (2, 1500, 384) frames
     from ``make_batch`` (``run_training`` feeds no frames, in either
     package), the numbers of phase I but the stall share and goodput;
     then the f32 check of the whole model on 1 x 2080 tokens with frames;
     each of I, J and K prints its seconds;
 16. the grouped matmul's times at the Grok-1 and Kimi-K2 decode and
     prefill shapes, Grok-1's and Kimi-K2's 32k cells' shapes, and at the
     chunk off the
     path, against its bound, plain version and ``torch.bmm``; in f32 at
     Grok-1's decode and prefill chunk beside ``torch.bmm`` without TF32;
  B. the multi-host path on the card's host: ``bench_torch_multihost``'s
     ``--scale --quick`` cell (1,000 hosts over three federated clusters on
     routes local, med and high, through the port's ``MultiHostRun``), its
     virtual-clock metrics, ``events_total`` included, equal to
     ``benchmarks/baselines/multihost_scale.json``; its wall-clock checks
     (the CI budget, the events/sec floor) are printed and not judged,
     since they time the host;
  H. the dry run (``repro_torch.launch.dryrun_lib``, on ``meta`` tensors
     over a one-rank fake group, on the host, in a process of its own
     started with phase 1) against what phases 7, 11, 14, C, G, I and K
     measured: the train step's FLOPs of phases 14, C, I and K equal
     ``FlopCounterMode``'s count of each run's last step on the card, and
     its predicted peak (argument + temp + output - alias) is within 20%
     of the phase's ``max_memory_allocated`` (phase J is not counted: its
     count walks the sLSTM's 4096 steps a layer in Python on ``meta``
     tensors, too slow for this run); its kernel calls per prefill
     call and per decode step, times the calls and steps, equal the
     launches phases 7 and 11 counted, and so do those of each 32k cell
     at its depth and batch (decode_32k at pos 32767, long_500k at pos
     524,287; xLSTM's prefill_32k is not counted: its count walks 32,768
     sLSTM steps a layer in Python); each step and call
     these phases timed, the 32k cells' too, is printed beside its
     roofline bound on the H100 (the largest of the compute, memory and
     collective terms, ``launch.mesh.HW``) and the share; it prints its
     seconds;
     every f32 check is collected before it begins;
 17. one JSON line of kernels, then the result line.

Needs a CUDA card; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import gc
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from benchmarks import bench_torch_multihost, bench_torch_roofline  # noqa: E402
from benchmarks import bench_torch_wirefmt, torch_gate  # noqa: E402
from repro_torch.configs.base import (SHAPES, ArchConfig,  # noqa: E402
                                      ShapeConfig, get_arch)
from repro_torch.core import KVStore, LoaderConfig, build_stack  # noqa: E402
from repro_torch.data.datasets import (SyntheticPixelDataset,  # noqa: E402
                                       SyntheticTokenDataset, ingest)
from repro_torch.kernels import build as _build  # noqa: E402
from repro_torch.kernels import (cost, crop_norm,  # noqa: E402
                                 decode_attention, flash_attention,
                                 grouped_matmul, ops, ref)
from repro_torch.kernels.cost import PEAKS, causal_pairs  # noqa: E402
from repro_torch.launch.dryrun_lib import peak_bytes, run_cell  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.mesh import destroy as destroy_group  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.moe import n_chunks  # noqa: E402
from repro_torch.models.params import (count_params, tree_leaves,  # noqa: E402
                                      tree_map, tree_unflatten)
from repro_torch.serve import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.sharding.rules import tree_shardings  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.compression import (  # noqa: E402
    compressed_psum_grads, init_error_feedback)
from repro_torch.train.loop import TrainLoopConfig, run_training  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         adamw_update)
from repro_torch.train.step import (  # noqa: E402
    abstract_state, init_state, make_prefill_step, make_serve_step,
    make_train_step, state_logical_axes)

# The main path: LoaderConfig's default batch, 256x256x3 uint8 frames,
# 224x224 crops.
B, H, W, C, OH, OW = 512, 256, 256, 3, 224, 224
N_SAMPLES = 4096
N_BATCHES = 6
MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)
SOURCE = "src/repro_torch/kernels/csrc/crop_norm.cu"
REPLACES = "src/repro/kernels/crop_norm.py:38"
# name -> (module, source of the kernel the main path runs (bf16 where a
# kernel has an f32 and a bf16 variant), the TPU kernel it replaces)
KERNELS = {
    "crop_mirror_normalize": (crop_norm, SOURCE, REPLACES),
    "flash_attention": (flash_attention,
                        "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
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
# The other families' serving paths (phases D, E, F), each at its config's
# full width and full depth, bf16, seeded random weights, prompts fetched
# over the simulated WAN, 32 new tokens a prompt:
# - Hymba-1.5B, 32 layers: 16 prompts of 128 tokens, a 4 x 2048 prefill
#   (past its 1024-token window), 8 slots over a 2048-token cache (a ring
#   of 1024); its f32 check runs 2 layers on one slot with a 1050-token
#   prompt and 16 new tokens, so that decode passes the window and the
#   ring wraps;
# - xLSTM-350M, 24 layers (12 mLSTM/sLSTM pairs): 16 prompts of 128
#   tokens, a 2 x 2048 prefill (the sLSTM a loop of 2048 steps a layer),
#   8 slots; its f32 check runs 2 layers (one pair);
# - Whisper-tiny, 4 encoder and 4 decoder layers: 16 prompts of 64 tokens,
#   an 8 x 448 prefill (its decoder's length) with make_batch's frames
#   (8, 1500, 384), 8 slots over a 448-token cache; its f32 check runs the
#   whole model.
# phase -> (config, drive_serving's sizes, the f32 check's: layers kept,
# one prompt of that many tokens, check_f32_path's sizes).
FAMILY_PHASES = {
    "D": ("hymba_1_5b",
          dict(n_prompts=16, prompt_len=128, prefill_b=4, prefill_s=2048,
               slots=8, max_seq=2048, new_tokens=32, n_prefill=2),
          dict(n_layers=2, prompt=1050, prefill_len=1050,
               n_steps=1050 + 16 - 1, slots=1, max_seq=2048,
               new_tokens=16)),
    "E": ("xlstm_350m",
          dict(n_prompts=16, prompt_len=128, prefill_b=2, prefill_s=2048,
               slots=8, max_seq=2048, new_tokens=32, n_prefill=2),
          dict(n_layers=2)),
    "F": ("whisper_tiny",
          dict(n_prompts=16, prompt_len=64, prefill_b=8, prefill_s=448,
               slots=8, max_seq=448, new_tokens=32, n_prefill=3),
          dict(prefill_len=448, max_seq=448)),
}
# The four configs that no earlier phase serves (phases L, M, N and O),
# each at full width, bf16, seeded random weights, through drive_family
# with KIMI_SERVE's sizes (8 prompts of 64 tokens over the simulated WAN,
# a 2 x 2048 prefill, 8 slots over a 1024-token cache, 16 new tokens, 2
# prefill calls):
# - Qwen3-14B whole: 40 query heads over 8 kv heads (G = 5), d_model 5120;
# - Yi-34B at 30 of its 60 layers: 56 query heads over 8 (G = 7); its
#   33.9e9 parameters whole take 67.9 GB in bf16 (derived), which leaves
#   no room for decode_32k's cache on an 80 GB card: 30 layers take 34.4
#   GB (derived) and leave a batch of 4 for it (decode_32k_batch);
# - StableLM-2-1.6B whole: 32 query heads over 32 kv heads (G = 1), D = 64;
# - InternVL2-2B whole: 16 query heads over 8 (G = 2), D = 128, with
#   make_batch's 256 patch embeddings through batch_extras.
# Their f32 checks run 2 layers at full width (check_f32_path's sizes);
# InternVL2's prefills 512 tokens, so that text follows its 256 patches.
# phase -> (config, layers run (None: all), the f32 check's cut and sizes)
CONFIG_PHASES = {
    "L": ("qwen3_14b", None, dict(n_layers=CHECK_LAYERS)),
    "M": ("yi_34b", 30, dict(n_layers=CHECK_LAYERS)),
    "N": ("stablelm_1_6b", None, dict(n_layers=CHECK_LAYERS)),
    "O": ("internvl2_2b", None, dict(n_layers=CHECK_LAYERS,
                                     prefill_len=512)),
}
# The reference's prefill_32k and decode_32k cells (configs/base.py
# SHAPES), run through make_prefill_step and make_serve_step on the
# parameters a serving phase holds, before it frees them: Qwen3-4B (phase
# 7), Grok-1 at phase 11's 4 layers, and phases L-O's configs at their
# depth (drive_cells).  prefill_32k: one row of 32,768 tokens (the
# reference's batch of 32 cut to 1: at Qwen3-4B's vocabulary the f32 logits
# of one row take 19.9 GB, derived, and unembed adds an f32 copy of the
# embedding), 2 calls, the second timed.  decode_32k: a cache from
# init_cache(B, 32768), its K and V drawn from a seeded generator and its
# pos set to 32768 - 4, then 4 serve steps, the last over all 32,768 keys
# (writes stay inside the cache); the batch of 128 cut to the largest
# power of two whose bf16 weights and cache leave CARD_FREE of the card's
# CARD_GB free (decode_32k_batch: the batches below).
SEQ_32K = 32768
PREFILL_32K_CALLS, DECODE_32K_STEPS = 2, 4
CARD_GB, CARD_FREE = 80, 0.2
DECODE_32K_BATCH = {"7": 8, "11": 32, "L": 4, "M": 4, "N": 8, "O": 16}
# The other four configs' cells, on the weights of the phase that serves
# them: Kimi-K2 at phase 13's 1 of 61 layers, Hymba-1.5B, xLSTM-350M and
# Whisper-tiny whole (phases D, E and F).  decode_32k's batch is
# decode_32k_batch's, from each family's own cache (``cache_specs``):
# Kimi-K2's 36.4 GB of bf16 weights and 117 MB a slot, Hymba's ring of
# 1024 slots and its Mamba state, xLSTM's states, Whisper's 32,768-token
# self cache and 1500-frame cross cache leave the reference's 128 uncut.
FAMILY_CELL_BATCH = {"13": 128, "D": 128, "E": 128, "F": 128}
# long_500k (one row, a 524,288-token context) for the families that run
# it (LONG_CONTEXT_FAMILIES): Hymba (its ring of 1024 slots) and xLSTM (no
# position), 4 serve steps, the last at position 524,287.
LONG_500K = SHAPES["long_500k"].seq_len
LONG_CELL_PHASES = ("D", "E")
# prefill_32k's depth where it is cut: xLSTM runs its first mLSTM/sLSTM
# pair (2 of 24 layers), whose sLSTM walks 32,768 steps, one Python step
# each, about 10 s a call (derived from 7.40 s for 2 x 2048 at 24 layers;
# 24 layers would take about 2 minutes a call).
CELL_PREFILL_LAYERS = {"E": 2}
# Steps of make_serve_step from init_cache, on seeded tokens at the cell's
# batch, that bring a recurrent state (Hymba's Mamba h and conv, xLSTM's
# mLSTM and sLSTM states: its m is a log-space stabiliser and its n a
# normaliser, which random values could overflow or bring near 0) to
# values the model itself makes, before a decode cell draws its K and V and
# sets its position.
WARM_STEPS = 32
# The cells that phase H does not count, with the reason.
DRY_NOT_COUNTED = {
    "phase E prefill_32k call": "its count walks 32,768 sLSTM steps a "
    "layer in Python on meta tensors, as phase J's would"}
# Kernel sweeps: the reference's (tests/test_kernels.py:17-62) with head
# dim 112 added, and the serving paths' own shapes: Qwen3-4B's, Grok-1's
# (48 query heads over 8 kv heads) and Kimi-K2's (64 over 8 at head dim
# 112).  Attention (B,H,K,S,D); decode (B,K,G,T,D).
FLASH_CASES = [(1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 2, 96, 32),
               (1, 2, 1, 128, 128), (2, 4, 2, 100, 16), (1, 8, 2, 200, 112),
               (1, 10, 2, 160, 64), (2, 5, 1, 100, 32)]
# Non-causal attention of S queries against T != S keys (cross-attention),
# (B,H,K,S,T,D), in both dtypes under TOL.
FLASH_CROSS_CASES = [(2, 4, 4, 37, 100, 64), (1, 6, 6, 130, 75, 32),
                     (2, 10, 2, 64, 200, 16), (1, 5, 1, 1, 129, 64)]
FLASH_WINDOWS = (0, 16, 100)
# f32 sweeps on the f32 kernel's tile edges, (B,H,K,S,T,D), causal,
# window, under TOL at each of its query blocks (64 and 128 rows,
# 128-key tiles): S = 127, 128 and 129 rows, windows of 100 and 200 keys
# that straddle a 128-key tile, and one key against 130 queries.
FLASH_F32_EDGES = [((1, 4, 2, 127, 127, 128), True, 0),
                   ((1, 4, 2, 128, 128, 112), True, 0),
                   ((2, 4, 1, 129, 129, 64), True, 0),
                   ((1, 4, 2, 129, 129, 32), False, 0),
                   ((1, 4, 4, 300, 300, 128), True, 100),
                   ((1, 5, 1, 400, 400, 64), True, 200),
                   ((1, 4, 2, 130, 1, 64), False, 0),
                   ((1, 4, 2, 130, 1, 16), False, 0)]
FLASH_PATH_CASES = [((PREFILL_B, 32, 8, PREFILL_S, 128), torch.bfloat16),
                    ((1, 32, 8, CHECK_PREFILL, 128), torch.float32),
                    ((2, 48, 8, 2048, 128), torch.bfloat16),
                    ((2, 64, 8, 2048, 112), torch.bfloat16),
                    ((1, 64, 8, CHECK_PREFILL, 112), torch.float32),
                    ((2, 40, 8, 2048, 128), torch.bfloat16),
                    ((2, 56, 8, 2048, 128), torch.bfloat16),
                    ((2, 32, 32, 2048, 64), torch.bfloat16),
                    ((2, 16, 8, 2048, 128), torch.bfloat16)]
# Phases L-O's f32 checks' prefills (B,H,K,S,D), checked in f32 as the path
# shapes are: Qwen3-14B's, Yi-34B's, StableLM's and InternVL2's (512
# tokens).
FLASH_CONFIG_F32_CASES = [(1, 40, 8, CHECK_PREFILL, 128),
                          (1, 56, 8, CHECK_PREFILL, 128),
                          (1, 32, 32, CHECK_PREFILL, 64),
                          (1, 16, 8, 512, 128)]
# The prefill_32k cells' attention (B,H,K,S,D), bf16, causal: Qwen3-4B's,
# Grok-1's, Qwen3-14B's, Yi-34B's (G = 7), StableLM's (32 kv heads at D =
# 64) and InternVL2's.  The plain version's (B,K,G,S,T) f32 scores would
# take 137 GB at Qwen3-4B's 32 heads, so phase 6 holds the kernel's output
# one kv group at a time (``grouped_reference``, G x 4.3 GB), on the first
# and the last group.
FLASH_32K_CASES = [(1, 32, 8, SEQ_32K, 128), (1, 48, 8, SEQ_32K, 128),
                   (1, 40, 8, SEQ_32K, 128), (1, 56, 8, SEQ_32K, 128),
                   (1, 32, 32, SEQ_32K, 64), (1, 16, 8, SEQ_32K, 128)]
DECODE_CASES = [(2, 2, 2, 256, 64), (1, 4, 1, 100, 32), (3, 1, 8, 512, 128),
                (2, 2, 2, 40, 16), (2, 8, 8, 300, 112), (2, 5, 5, 300, 64),
                (3, 1, 5, 77, 16)]
DECODE_PATH_CASES = [((SLOTS, 8, 4, MAX_SEQ, 128), torch.bfloat16),
                     ((SLOTS, 8, 4, CHECK_MAX_SEQ, 128), torch.float32),
                     ((8, 8, 6, 1024, 128), torch.bfloat16),
                     ((8, 8, 8, 1024, 112), torch.bfloat16),
                     ((8, 8, 8, CHECK_MAX_SEQ, 112), torch.float32),
                     ((8, 5, 5, 1024, 64), torch.bfloat16),
                     ((1, 5, 5, 1024, 64), torch.float32),
                     ((8, 6, 1, 448, 64), torch.bfloat16),
                     ((8, 6, 1, 1500, 64), torch.bfloat16),
                     ((8, 6, 1, 448, 64), torch.float32),
                     ((8, 6, 1, 1500, 64), torch.float32),
                     ((8, 8, 5, 1024, 128), torch.bfloat16),
                     ((8, 8, 7, 1024, 128), torch.bfloat16),
                     ((8, 32, 1, 1024, 64), torch.bfloat16),
                     ((8, 8, 2, 1024, 128), torch.bfloat16),
                     ((8, 8, 5, CHECK_MAX_SEQ, 128), torch.float32),
                     ((8, 8, 7, CHECK_MAX_SEQ, 128), torch.float32),
                     ((8, 32, 1, CHECK_MAX_SEQ, 64), torch.float32),
                     ((8, 8, 2, CHECK_MAX_SEQ, 128), torch.float32)]
# The decode_32k cells' decode (B,K,G,T,D) at their batches
# (DECODE_32K_BATCH), bf16, in the order of FLASH_32K_CASES: checked in
# phase 6 at lengths 1, T // 3 and T and at ragged lengths, and timed in
# phase 9.  G = 7 and G = 2 run as padded rows of the tensor-core kernel's
# 8-row A operand, as G = 4, 5 and 6 do.
DECODE_32K_CASES = [(8, 8, 4, SEQ_32K, 128), (32, 8, 6, SEQ_32K, 128),
                    (4, 8, 5, SEQ_32K, 128), (4, 8, 7, SEQ_32K, 128),
                    (8, 32, 1, SEQ_32K, 64), (16, 8, 2, SEQ_32K, 128)]
# The other families' cells' attention, bf16, as FLASH_MASK_PATH_CASES,
# (B,H,K,S,T,D), causal, window: Kimi-K2's prefill_32k (64 query heads over
# 8 at D = 112), Hymba's (25 over 5, its 1024-token window), Whisper-tiny's
# decoder self-attention over 32,768 positions and its cross-attention of
# 32,768 queries over 1500 frames.  Checked in phase 6 one kv group at a
# time on the first and the last group, a group cut into pieces of query
# heads where its f32 scores would pass PLAIN_SCORES_BYTES
# (``grouped_reference``), and timed in phase 9.
FLASH_32K_FAMILY_CASES = [((1, 64, 8, SEQ_32K, SEQ_32K, 112), True, 0),
                          ((1, 25, 5, SEQ_32K, SEQ_32K, 64), True, 1024),
                          ((1, 6, 6, SEQ_32K, SEQ_32K, 64), True, 0),
                          ((1, 6, 6, SEQ_32K, 1500, 64), False, 0)]
# The most f32 scores (bytes) one plain attention call of phase 6's 32k
# checks holds: Yi-34B's G = 7 group (30.1 GB, about 60 GB with the
# softmax's copies on the empty card) stays whole; Kimi-K2's G = 8 (34.4
# GB) runs as two pieces of 4 heads.
PLAIN_SCORES_BYTES = 32e9
# Their decode (B,K,G,T,D), bf16, checked in phase 6 as DECODE_32K_CASES
# and timed in phase 9: Kimi-K2's decode_32k at 128 slots, Hymba's ring of
# 1024 slots at decode_32k's 128 slots and long_500k's one, Whisper-tiny's
# self cache of 32,768 and cross cache of 1500 frames at 128 slots.
DECODE_32K_FAMILY_CASES = [(128, 8, 8, SEQ_32K, 112), (128, 5, 5, 1024, 64),
                           (1, 5, 5, 1024, 64), (128, 6, 1, SEQ_32K, 64),
                           (128, 6, 1, 1500, 64)]
# The other families' attention at their path shapes, where the mask is not
# Qwen3-4B's causal S = T: (B,H,K,S,T,D), dtype, causal, window.  Hymba's
# prefill (25 query heads over 5 kv heads, a 1024-token window, S past it)
# and its f32 check's; Whisper-tiny's encoder (non-causal over 1500
# frames), decoder self-attention (causal over its 448 tokens) and
# cross-attention (448 queries against 1500 frames), and its f32 check's.
FLASH_MASK_PATH_CASES = [
    ((4, 25, 5, 2048, 2048, 64), torch.bfloat16, True, 1024),
    ((1, 25, 5, 1050, 1050, 64), torch.float32, True, 1024),
    ((8, 6, 6, 1500, 1500, 64), torch.bfloat16, False, 0),
    ((8, 6, 6, 448, 448, 64), torch.bfloat16, True, 0),
    ((8, 6, 6, 448, 1500, 64), torch.bfloat16, False, 0),
    ((1, 6, 6, 1500, 1500, 64), torch.float32, False, 0),
    ((1, 6, 6, 448, 448, 64), torch.float32, True, 0),
    ((1, 6, 6, 448, 1500, 64), torch.float32, False, 0)]
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
                  ("flash_attention kimi", (2, 64, 8, 2048, 112)),
                  ("flash_attention qwen3-14b", (2, 40, 8, 2048, 128)),
                  ("flash_attention yi", (2, 56, 8, 2048, 128)),
                  ("flash_attention stablelm", (2, 32, 32, 2048, 64)),
                  ("flash_attention internvl2", (2, 16, 8, 2048, 128))]
# Timed at 32k (phase 9): Qwen3-4B's prefill_32k and the two code paths it
# does not take, G = 7 (Yi-34B) and D = 64 over 32 kv heads (StableLM);
# the plain version one kv group at a time over every group.
TIME_ATTENTION_32K = [("flash_attention 32k", FLASH_32K_CASES[0]),
                      ("flash_attention 32k yi", FLASH_32K_CASES[3]),
                      ("flash_attention 32k stablelm", FLASH_32K_CASES[4])]
# Timed at the other families' 32k shapes, with their masks: (name,
# (B,H,K,S,T,D), causal, window), FLASH_32K_FAMILY_CASES.
TIME_ATTENTION_32K_FAMILY = [
    (f"flash_attention 32k {name}", shape, causal, window)
    for name, (shape, causal, window) in zip(
        ("kimi", "hymba", "whisper self", "whisper cross"),
        FLASH_32K_FAMILY_CASES)]
TIME_DECODES = [("flash_decode", TIME_DECODE),
                ("flash_decode serving", (SLOTS, 8, 4, MAX_SEQ, 128)),
                ("flash_decode grok", (8, 8, 6, 1024, 128)),
                ("flash_decode kimi", (8, 8, 8, 1024, 112)),
                ("flash_decode hymba", (8, 5, 5, 1024, 64)),
                ("flash_decode whisper self", (8, 6, 1, 448, 64)),
                ("flash_decode whisper cross", (8, 6, 1, 1500, 64)),
                ("flash_decode qwen3-14b", (8, 8, 5, 1024, 128)),
                ("flash_decode yi", (8, 8, 7, 1024, 128)),
                ("flash_decode stablelm", (8, 32, 1, 1024, 64)),
                ("flash_decode internvl2", (8, 8, 2, 1024, 128))] + [
    (f"flash_decode 32k {name}", shape) for name, shape in zip(
        ("qwen3-4b", "grok", "qwen3-14b", "yi", "stablelm", "internvl2"),
        DECODE_32K_CASES)] + [
    (f"flash_decode {name}", shape) for name, shape in zip(
        ("32k kimi", "32k hymba", "long_500k hymba", "32k whisper self",
         "32k whisper cross"), DECODE_32K_FAMILY_CASES)]
# A timed decode row whose K and V take more bytes than this runs 5 x 5
# launches a measurement, not 20 x 20 (Kimi-K2's 15 GB cache, Whisper's
# 6.4 GB).
DECODE_TIME_BIG = 5e9
# The f32 decode kernel at the dense serving path's shape, beside SDPA in
# f32 (phase 9).
TIME_DECODE_F32 = ("flash_decode serving f32", (SLOTS, 8, 4, MAX_SEQ, 128))
# Timed at the other families' bf16 prefill shapes: (name, (B,H,K,S,T,D),
# causal, window), as FLASH_MASK_PATH_CASES.
TIME_MASKED_ATTENTION = [
    (f"flash_attention {name}", shape, causal, window)
    for name, (shape, dtype, causal, window) in zip(
        ("hymba", "whisper encoder", "whisper self", "whisper cross"),
        [c for c in FLASH_MASK_PATH_CASES if c[1] == torch.bfloat16])]
# Timed in f32 (phase 9): Qwen3-4B's prefill, every f32 shape of the
# serving paths' checks (FLASH_PATH_CASES, FLASH_MASK_PATH_CASES) and a
# full-width D = 64 shape with Hymba's window: (name, (B,H,K,S,T,D),
# causal, window).
TIME_ATTENTION_F32 = [
    ("flash_attention f32", (PREFILL_B, 32, 8, PREFILL_S, PREFILL_S, 128),
     True, 0),
    ("flash_attention f32 d64", (4, 25, 5, 2048, 2048, 64), True, 1024)] + [
    (f"flash_attention f32 {name}", shape, causal, window)
    for name, (shape, causal, window) in zip(
        ("qwen check", "kimi check", "hymba check", "whisper encoder check",
         "whisper self check", "whisper cross check"),
        [((B, H, K, S, S, D), True, 0) for (B, H, K, S, D), dtype
         in FLASH_PATH_CASES if dtype == torch.float32]
        + [(shape, causal, window) for shape, dtype, causal, window
           in FLASH_MASK_PATH_CASES if dtype == torch.float32])]
# Launched twice on the same inputs in phase 6, whose outputs must be the
# same bits: bf16 decode at decode_32k and at the dense serving path's
# shape (each row's CTAs folded in a fixed order).
DECODE_REPEAT_CASES = [TIME_DECODE, (SLOTS, 8, 4, MAX_SEQ, 128)]
# The live length of each serving path's cache half way through its engine
# run (models/attention.py passes min(pos + 1, T) to every slot, pos one
# shared count of the steps: 318 steps for Qwen3-4B and Hymba, 158 for
# Grok-1, 79 for Kimi-K2 and phases L-O, 190 for Whisper-tiny, whose
# cross-attention always reads all 1500 frames): checked in phase 6 and
# timed in phase 9 beside the full cache.
DECODE_LIVE = {(SLOTS, 8, 4, MAX_SEQ, 128): 160, (8, 8, 6, 1024, 128): 80,
               (8, 8, 8, 1024, 112): 40, (8, 5, 5, 1024, 64): 160,
               (8, 6, 1, 448, 64): 95, (8, 6, 1, 1500, 64): 1500,
               (8, 8, 5, 1024, 128): 40, (8, 8, 7, 1024, 128): 40,
               (8, 32, 1, 1024, 64): 40, (8, 8, 2, 1024, 128): 40}

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
# prefill chunk in f32 as well; Grok-1's prefill_32k chunk (one row: C =
# 160) and its decode_32k step (32 slots), each with its down projection.
GMM_CASES = [(4, 64, 96, 64), (2, 100, 64, 48), (8, 32, 128, 128)]
GMM_EDGE_CASES = [(3, 1, 200, 72), (2, 1, 99, 37), (3, 13, 1000, 300),
                  (1, 77, 24, 129)]
GMM_DECODE = (8, 8, 6144, 32768)
GMM_DECODE_DOWN = (8, 8, 32768, 6144)
GMM_PREFILL = (8, 320, 6144, 32768)
GMM_PREFILL_DOWN = (8, 320, 32768, 6144)
GMM_PREFILL_B1 = (8, 160, 6144, 32768)
GMM_PREFILL_B1_DOWN = (8, 160, 32768, 6144)
GMM_DECODE_32K = (8, DECODE_32K_BATCH["11"], 6144, 32768)
GMM_DECODE_32K_DOWN = (8, DECODE_32K_BATCH["11"], 32768, 6144)
# Kimi-K2's: 384 experts, d 7168, d_ff 2048, top-8; decode gives
# C = ceil(8 * 1.25 / 384) = 1 per slot, a prefill chunk
# ceil(512 * 8 * 1.25 / 384) = 14 per row, times 2 rows.
KIMI_GMM_DECODE = (384, 8, 7168, 2048)
KIMI_GMM_DECODE_DOWN = (384, 8, 2048, 7168)
KIMI_GMM_PREFILL = (384, 28, 7168, 2048)
KIMI_GMM_PREFILL_DOWN = (384, 28, 2048, 7168)
# Kimi-K2's cells (models/moe.py: C = ceil(S * top_k * 1.25 / 384) rows an
# expert for each row of S tokens): a prefill_32k chunk of one row (S =
# 512: C = 14) and a decode_32k step of 128 slots (S = 1: C = 1 a slot).
KIMI_GMM_PREFILL_B1 = (384, 14, 7168, 2048)
KIMI_GMM_PREFILL_B1_DOWN = (384, 14, 2048, 7168)
KIMI_GMM_DECODE_32K = (384, FAMILY_CELL_BATCH["13"], 7168, 2048)
KIMI_GMM_DECODE_32K_DOWN = (384, FAMILY_CELL_BATCH["13"], 2048, 7168)
GMM_PATH_CASES = [(GMM_DECODE, torch.bfloat16),
                  (GMM_DECODE_DOWN, torch.bfloat16),
                  (GMM_PREFILL, torch.bfloat16),
                  (GMM_PREFILL_DOWN, torch.bfloat16),
                  (KIMI_GMM_DECODE, torch.bfloat16),
                  (KIMI_GMM_DECODE_DOWN, torch.bfloat16),
                  (KIMI_GMM_PREFILL, torch.bfloat16),
                  (KIMI_GMM_PREFILL_DOWN, torch.bfloat16),
                  (GMM_DECODE, torch.float32), (GMM_PREFILL, torch.float32),
                  (GMM_PREFILL_DOWN, torch.float32),
                  (GMM_PREFILL_B1, torch.bfloat16),
                  (GMM_PREFILL_B1_DOWN, torch.bfloat16),
                  (GMM_DECODE_32K, torch.bfloat16),
                  (GMM_DECODE_32K_DOWN, torch.bfloat16),
                  (KIMI_GMM_PREFILL_B1, torch.bfloat16),
                  (KIMI_GMM_PREFILL_B1_DOWN, torch.bfloat16),
                  (KIMI_GMM_DECODE_32K, torch.bfloat16),
                  (KIMI_GMM_DECODE_32K_DOWN, torch.bfloat16)]
# Timed: gate/up and down projections at decode and in a prefill chunk,
# with (back-to-back launches, repeats) sized to keep the phase in seconds.
TIME_GMM = [("decode", GMM_DECODE, 5, 5),
            ("decode down", GMM_DECODE_DOWN, 5, 5),
            ("prefill", GMM_PREFILL, 5, 5),
            ("prefill down", GMM_PREFILL_DOWN, 5, 5),
            ("kimi decode", KIMI_GMM_DECODE, 3, 3),
            ("kimi decode down", KIMI_GMM_DECODE_DOWN, 3, 3),
            ("kimi prefill", KIMI_GMM_PREFILL, 3, 3),
            ("kimi prefill down", KIMI_GMM_PREFILL_DOWN, 3, 3),
            ("prefill b1", GMM_PREFILL_B1, 5, 5),
            ("prefill b1 down", GMM_PREFILL_B1_DOWN, 5, 5),
            ("decode 32k", GMM_DECODE_32K, 5, 5),
            ("decode 32k down", GMM_DECODE_32K_DOWN, 5, 5),
            ("kimi prefill b1", KIMI_GMM_PREFILL_B1, 3, 3),
            ("kimi prefill b1 down", KIMI_GMM_PREFILL_B1_DOWN, 3, 3),
            ("kimi decode 32k", KIMI_GMM_DECODE_32K, 3, 3),
            ("kimi decode 32k down", KIMI_GMM_DECODE_32K_DOWN, 3, 3)]
# A prefill chunk of a batch size the paths do not run, where the bf16
# kernel takes a tile of its own (grouped_matmul.plan): Kimi-K2 at four
# rows (C = 4 x 14 = 56, the 64-row mma.sync tile).  Checked in bf16
# within GMM_PATH_TOL (phase 10) and timed (phase 16), as TIME_GMM.
GMM_OFF_PATH = [("kimi prefill b4", (384, 56, 7168, 2048), 3, 3)]
# The f32 kernel timed at Grok-1's decode, prefill chunk and its down
# projection (phase 16), beside torch.bmm in f32 with TF32 off, as
# TIME_GMM.
TIME_GMM_F32 = [("decode f32", GMM_DECODE, 2, 3),
                ("prefill f32", GMM_PREFILL, 1, 3),
                ("prefill down f32", GMM_PREFILL_DOWN, 1, 3)]
# Launched twice on the same inputs in phase 10, whose outputs must be the
# same bits: the small-C stream's down projections, Grok-1's (its CTAs'
# ranges cut the last items, whose pieces a second pass adds in a fixed
# order) and Kimi-K2's (whole items in rounds).
GMM_REPEAT_CASES = [GMM_DECODE_DOWN, KIMI_GMM_DECODE_DOWN]
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
# global batch of 2 (train_4k's 256, cut by one card's memory), 3 steps of
# run_training over route high (the first is warm-up, the second timed,
# the last runs under the flop counter; 3, not 8, so that the script with
# phases I-K stays inside its time limit on a slower host: one H100 host
# took 1287.9 s with 4 steps here and two of xLSTM's; phases C, G and I
# take the same).  The f32
# check (phase 15) runs 2 layers at full width on 1 x 256 tokens for 3 steps on
# the card and on the CPU: losses within CHECK_TOL, and the first step's
# gradients within CHECK_TOL of each leaf's max |g|; then a restart from a
# checkpoint on the card at the quickstart config.
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 4096, 3
TRAIN_OPT = dict(peak_lr=3e-4, warmup_steps=2)
TRAIN_CHECK_B, TRAIN_CHECK_S, TRAIN_CHECK_STEPS = 1, 256, 3
RESTART_CFG = dict(name="quickstart-lm", family="dense", n_layers=2,
                   d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                   vocab=2048, head_dim=32, dtype="float32", remat=False)
# The MoE training path (phase C): Grok-1 at full width, 1 of its 64
# layers: 5.73e9 parameters (experts 4.83e9, attention 8.8e7, the
# embedding, which also unembeds, 8.05e8), at 12 B each (bf16 parameters
# and gradients, f32 moments) 68.7 GB before activations; 2 x 2048 tokens,
# four 512-token chunks a row.  The f32 check cuts d_ff to 256 and the
# vocabulary to 32768 (0.33e9 parameters) and runs 1 x 1024 tokens, two
# chunks, for 3 steps: at Grok-1's 131072 the CPU side took 219.6 s (the
# unembedding and the update of the 0.8e9-element embedding), and
# 32768 x 6144 still exceeds ``CHUNK_ELEMS``, so the embedding's row
# blocks run on both sides.
MOE_TRAIN_LAYERS = 1
MOE_TRAIN_B, MOE_TRAIN_S = 2, 2048
MOE_TRAIN_CHECK_D_FF = 256
MOE_TRAIN_CHECK_VOCAB = 32768
MOE_TRAIN_CHECK_B, MOE_TRAIN_CHECK_S = 1, 1024
# The int8 training path (phase G): Grok-1 at full width, 2 of its 64
# layers, with int8 AdamW moments, the reference's memory policy for
# Grok-1 (``repro/launch/dryrun_lib.py``): 10.64e9 parameters at 6 B each
# (bf16 parameters and gradients, int8 m and v; the f32 scales add 4 B a
# row) 63.9 GB before activations, where the f32 moments of phase C fit 1
# layer; 2 x 2048 tokens as phase C.  Its f32 check is
# phase C's (1 layer, d_ff 256, vocabulary 32768, 3 steps) on 1 x 512
# tokens, one chunk (the two chunks are phase C's to check; at 1024 the
# two states' CPU sides took 92.3 and 86.0 s, most of it the forward and
# backward), for each quantized state dtype; the embedding's row blocks
# take the factored moment's two passes over them on both sides.  Then the
# int8 state saved and restored onto a 1 x 1 mesh over a one-rank NCCL
# group, and ``compressed_psum_grads`` over that group on the first
# step's gradients.
INT8_TRAIN_LAYERS = 2
INT8_STATE = "int8"
INT8_CHECK_STATES = ("int8", "int8_factored")
INT8_CHECK_S = 512
# The hybrid, SSM and audio training paths (phases I, J and K): Whisper-tiny
# (4 + 4) whole, Hymba-1.5B at 16 of its 32 layers (its step is
# launch-bound, about 10 s at 32) and xLSTM-350M at 4 of its 24
# (``FAMILY_TRAIN_LAYERS``), bf16, remat, f32 AdamW moments, seeded
# random weights, phase 14's 2 x 4096 tokens and its 3 steps (Whisper 8:
# they take 0.2 s).  xLSTM runs 1: its sLSTM is a loop of 4096 steps a
# layer, walked three times a step (the forward, remat's recompute and the
# backward), host-bound: 145.6-151.4 s a step at 24 layers on the H100,
# which with the rest passed the run's 1200 s limit on a slower host, so
# its depth is cut to 2 pairs (about 25 s).  That step is timed, warm-up
# included (5-10% above a second step), without the flop counter (phase
# H does not count it).  The f32 checks keep the width and cut depth and
# length only: Hymba 2 layers on 1 x
# 2080 tokens (past 2048, so attention goes chunked, past the 1024-token
# window, 9 Mamba chunks, the last ragged), xLSTM one pair on 1 x 544
# (three mLSTM chunks, the last ragged, and 544 sLSTM steps), Whisper
# whole on 1 x 2080 with frames.
# phase -> (config, drive_training's sizes, the f32 check's cut and sizes)
FAMILY_TRAIN = {
    "I": ("hymba_1_5b", dict(steps=TRAIN_STEPS),
          dict(n_layers=2, seq=2080)),
    "J": ("xlstm_350m", dict(steps=1, count_flops=False),
          dict(n_layers=2, seq=544)),
    "K": ("whisper_tiny", dict(steps=8), dict(seq=2080)),
}
FAMILY_TRAIN_LAYERS = {"hymba_1_5b": 16, "xlstm_350m": 4}
# CPU sides outstanding (running or queued) in one f32 worker before a new
# one waits: each holds its weights in shared memory until its result is
# back; the training checks' seven are submitted at once.
F32_QUEUED = 8
# Phase H: the dry run's predicted peak (argument + temp + output - alias)
# against the training phases' max_memory_allocated.
PEAK_TOL = 0.2


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


def median_event_ms(fn, n: int = 20, repeats: int = 20,
                    warmup: int = 3) -> float:
    """Median over ``repeats`` of the device time of ``n`` back-to-back
    calls between one pair of CUDA events, per call, after ``warmup``
    calls."""
    for _ in range(warmup):
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
    """Least time for the main-path call on this card:
    ``cost.crop_work`` over its data-sheet peaks (f32 operations)."""
    flops, nbytes = cost.crop_work(B, C, OH, OW, out_bytes_per_elem)
    ms, by = cost.roof(kind, nbytes, flops, "f32_flops")
    return nbytes, ms, by


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


def flash_blocks(q, k, v, *, causal: bool = True, window: int = 0) -> list:
    """(label, output) of ``ops.flash_attention``; for f32 on the card, of
    the f32 kernel at each of its query blocks (``F32_BLOCKS``), since a
    sweep's small shapes would otherwise take only the one the plan
    picks."""
    if q.device.type != "cuda" or q.dtype != torch.float32:
        return [("", ops.flash_attention(q, k, v, causal=causal,
                                         window=window))]
    return [(f" block {bq}", flash_attention.flash_attention(
        q, k, v, causal=causal, window=window, block_q=bq))
        for bq in flash_attention.F32_BLOCKS]


def grouped_reference(q, k, v, groups, *, causal: bool = True,
                      window: int = 0, heads: int = None):
    """The plain version one kv group at a time: for each g of
    ``groups``, (g, ``ref.mha_reference`` of query heads g*G..(g+1)*G-1
    against kv head g), which is that group's slice of the whole plain
    version's output, with G times the (S,T) f32 scores of one head where
    the whole takes H times.  With ``heads`` (a divisor of G), a group
    runs as pieces of that many query heads, side by side."""
    G = q.shape[1] // k.shape[1]
    step = heads or G
    for g in groups:
        kg, vg = k[:, g:g + 1], v[:, g:g + 1]
        pieces = [ref.mha_reference(q[:, h:h + step], kg, vg, causal=causal,
                                    window=window)
                  for h in range(g * G, (g + 1) * G, step)]
        yield g, pieces[0] if len(pieces) == 1 else torch.cat(pieces, 1)


def plain_heads(G: int, S: int, T: int) -> int:
    """Query heads a piece of ``grouped_reference`` at (S, T) takes: the
    largest divisor of G whose (S, T) f32 scores stay within
    ``PLAIN_SCORES_BYTES`` (at least one)."""
    return max([h for h in range(1, G + 1)
                if G % h == 0 and h * S * T * 4 <= PLAIN_SCORES_BYTES],
               default=1)


def check_attention(device) -> dict:
    """Phase 6: flash attention and flash decode against their plain
    versions on the same inputs.  The sweeps (f32 at every query block of
    its kernel, and ``FLASH_F32_EDGES``) use contiguous tensors and
    ``TOL``; the serving path's shapes use the model's layouts ((B,S,H,D)
    activations and the (B,T,K,D) cache), which the kernels read through
    strides, and ``path_tol``.  Returns the largest max|diff| of each
    kernel at the path's shapes."""
    gen = torch.Generator(device).manual_seed(6)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    def sweep(name, q, k, v, dtype, causal=True, window=0):
        want = ref.mha_reference(q, k, v, causal=causal, window=window)
        for label, got in flash_blocks(q, k, v, causal=causal,
                                       window=window):
            compare(name + label, got, want, dtype)

    path = {"flash_attention": 0.0, "flash_decode": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, K, S, D in FLASH_CASES:
            q, k, v = (randn(s, dtype) for s in ((B, H, S, D), (B, K, S, D),
                                                  (B, K, S, D)))
            for window in FLASH_WINDOWS:
                sweep(f"flash {dtype} {(B, H, K, S, D)} window {window}",
                      q, k, v, dtype, window=window)
            sweep(f"flash {dtype} {(B, H, K, S, D)} not causal", q, k, v,
                  dtype, causal=False)
        for B, H, K, S, T, D in FLASH_CROSS_CASES:
            q, k, v = (randn(s, dtype) for s in ((B, H, S, D), (B, K, T, D),
                                                  (B, K, T, D)))
            sweep(f"flash {dtype} {(B, H, K, S, T, D)} cross", q, k, v,
                  dtype, causal=False)
    dtype = torch.float32
    for (B, H, K, S, T, D), causal, window in FLASH_F32_EDGES:
        q, k, v = (randn(s, dtype) for s in ((B, H, S, D), (B, K, T, D),
                                              (B, K, T, D)))
        sweep(f"flash {dtype} {(B, H, K, S, T, D)} causal {causal} window "
              f"{window}", q, k, v, dtype, causal=causal, window=window)
    for (B, H, K, S, D), dtype in FLASH_PATH_CASES + [
            (shape, torch.float32) for shape in FLASH_CONFIG_F32_CASES]:
        q = randn((B, S, H, D), dtype).transpose(1, 2)
        k, v = (randn((B, S, K, D), dtype).transpose(1, 2) for _ in "kv")
        want = ref.mha_reference(q, k, v)
        err = compare(f"flash path {dtype} {(B, H, K, S, D)}",
                      ops.flash_attention(q, k, v), want, dtype,
                      path_tol(want, dtype))
        if dtype == torch.bfloat16:
            path["flash_attention"] = max(path["flash_attention"], err)
    for (B, H, K, S, T, D), dtype, causal, window in FLASH_MASK_PATH_CASES:
        q = randn((B, S, H, D), dtype).transpose(1, 2)
        k, v = (randn((B, T, K, D), dtype).transpose(1, 2) for _ in "kv")
        want = ref.mha_reference(q, k, v, causal=causal, window=window)
        err = compare(f"flash path {dtype} {(B, H, K, S, T, D)} causal "
                      f"{causal} window {window}",
                      ops.flash_attention(q, k, v, causal=causal,
                                          window=window),
                      want, dtype, path_tol(want, dtype))
        if dtype == torch.bfloat16:
            path["flash_attention"] = max(path["flash_attention"], err)
        del q, k, v, want
    path["flash_decode"] = check_decode(device)
    return path


def check_decode(device) -> float:
    """Phase 6's flash decode checks: the sweeps (``DECODE_CASES``, random
    lengths, ``TOL``), every path shape at lengths 1, T // 3 and T, and in
    bf16 at its live length and at ``ragged_lengths`` (``path_tol``), and
    two bf16 launches at each ``DECODE_REPEAT_CASES`` shape, which must
    give the same bits.  Returns the largest bf16 max|diff| at the path
    shapes."""
    gen = torch.Generator(device).manual_seed(7)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    for dtype in (torch.float32, torch.bfloat16):
        for B, K, G, T, D in DECODE_CASES:
            q, k, v = (randn(s, dtype) for s in ((B, K, G, D), (B, K, T, D),
                                                  (B, K, T, D)))
            lengths = torch.randint(1, T + 1, (B,), generator=gen,
                                    device=device)
            compare(f"decode {dtype} {(B, K, G, T, D)}",
                    ops.flash_decode(q, k, v, lengths),
                    ref.decode_reference(q.reshape(B, K * G, D), k, v,
                                         lengths).reshape(B, K, G, D), dtype)
    path = 0.0
    for (B, K, G, T, D), dtype in DECODE_PATH_CASES:
        q = randn((B, K, G, D), dtype)
        k, v = (randn((B, T, K, D), dtype).transpose(1, 2) for _ in "kv")
        runs = [(f"length {n}", [n] * B) for n in (1, T // 3, T)]
        if dtype == torch.bfloat16:
            live = DECODE_LIVE[B, K, G, T, D]
            runs += [(f"live length {live}", [live] * B),
                     ("ragged lengths", ragged_lengths(B, K, G, T, D))]
        err = check_decode_runs(f"decode path {dtype} {(B, K, G, T, D)}",
                                q, k, v, runs)
        if dtype == torch.bfloat16:
            path = max(path, err)
    for B, K, G, T, D in DECODE_REPEAT_CASES:
        q = randn((B, K, G, D), torch.bfloat16)
        k, v = (randn((B, T, K, D), torch.bfloat16).transpose(1, 2)
                for _ in "kv")
        lengths = torch.full((B,), T, dtype=torch.int32, device=device)
        first = ops.flash_decode(q, k, v, lengths)
        second = ops.flash_decode(q, k, v, lengths)
        if not torch.equal(first, second):
            raise AssertionError(f"decode {(B, K, G, T, D)}: two launches on "
                                 "the same inputs differ")
        print(f"check decode {(B, K, G, T, D)} bf16: two launches "
              "bit-identical")
        del q, k, v, first, second
    return path


def check_decode_runs(name: str, q, k, v, runs: list) -> float:
    """Flash decode on q (B,K,G,D) against k and v (B,K,T,D) at each
    (label, B lengths) of ``runs``, held to its plain version within
    ``path_tol``; returns the largest max|diff|."""
    B, K, G, D = q.shape
    err = 0.0
    for label, n in runs:
        lengths = torch.tensor(n, dtype=torch.int32, device=q.device)
        want = ref.decode_reference(q.reshape(B, K * G, D), k, v,
                                    lengths).reshape(B, K, G, D)
        err = max(err, compare(f"{name} {label}",
                               ops.flash_decode(q, k, v, lengths), want,
                               q.dtype, path_tol(want, q.dtype)))
    return err


def check_attention_32k(device, attention: list = None,
                        decode: list = None) -> dict:
    """Phase 6 at the 32k cells' shapes, in bf16 within ``path_tol``,
    in the model's layouts: flash attention at each of ``attention``
    (((B,H,K,S,T,D), causal, window), as ``FLASH_32K_FAMILY_CASES``; by
    default ``FLASH_32K_CASES``, causal), its output held one kv group at
    a time on the first and the last group (``grouped_reference``, in
    pieces of ``plain_heads`` query heads), and flash decode at each of
    ``decode`` (by default ``DECODE_32K_CASES``) at lengths 1, T // 3 and
    T and at ``ragged_lengths``.  Returns the largest max|diff| of each
    kernel."""
    gen = torch.Generator(device).manual_seed(8)
    dtype = torch.bfloat16

    def randn(shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    path = {"flash_attention": 0.0, "flash_decode": 0.0}
    if attention is None:
        attention = [((B, H, K, S, S, D), True, 0)
                     for B, H, K, S, D in FLASH_32K_CASES]
    for (B, H, K, S, T, D), causal, window in attention:
        q = randn((B, S, H, D)).transpose(1, 2)
        k, v = (randn((B, T, K, D)).transpose(1, 2) for _ in "kv")
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        G = H // K
        shape = (B, H, K, S, D) if (S, causal, window) == (T, True, 0) \
            else (B, H, K, S, T, D)
        mask = "" if (causal, window) == (True, 0) else \
            f" causal {causal} window {window}"
        for g, want in grouped_reference(
                q, k, v, sorted({0, K - 1}), causal=causal, window=window,
                heads=plain_heads(G, S, T)):
            err = compare(f"flash 32k {dtype} {shape}{mask} kv group {g}",
                          got[:, g * G:(g + 1) * G], want, dtype,
                          path_tol(want, dtype))
            path["flash_attention"] = max(path["flash_attention"], err)
            del want
        del q, k, v, got
    for B, K, G, T, D in DECODE_32K_CASES if decode is None else decode:
        q = randn((B, K, G, D))
        k, v = (randn((B, T, K, D)).transpose(1, 2) for _ in "kv")
        runs = [(f"length {n}", [n] * B) for n in (1, T // 3, T)]
        runs += [("ragged lengths", ragged_lengths(B, K, G, T, D))]
        path["flash_decode"] = max(path["flash_decode"], check_decode_runs(
            f"decode 32k {dtype} {(B, K, G, T, D)}", q, k, v, runs))
        del q, k, v
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
                  n_prefill: int = N_PREFILL, cells: dict = None) -> dict:
    """Phase 7: the serving path through the entry points a user calls:
    prompts fetched by the loader, ``make_prefill_step`` on a
    (prefill_b, prefill_s) batch, then ``ServingEngine.run`` on the
    prompts.  Returns the kernels' launches in this run, what it formed,
    and its times.  The prompts are returned for phase 8.  With
    ``cells`` (``drive_cells``' sizes), the engine is dropped and the 32k
    cells run on the same parameters, under ``"cells"``."""
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

    batch = dict(batch_extras(model, prefill_b, prefill_s),
                 tokens=prefill_tokens)
    reset_launches()
    times = []
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
    is_moe = getattr(model, "is_moe", False)
    if is_moe:
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
        "is_moe": is_moe, "after_prefill": after_prefill,
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
    if cells is not None:
        del engine
        out["cells"] = drive_cells(model, params, **cells)
    print(f"serving path {cfg.name}:", json.dumps(out))
    return out, prompts


def drive_cells(model, params: dict, *, decode_batch: int,
                seq: int = SEQ_32K, prefill_calls: int = PREFILL_32K_CALLS,
                decode_steps: int = DECODE_32K_STEPS, long_seq: int = None,
                prefill_layers: int = None,
                warm_steps: int = WARM_STEPS) -> dict:
    """The prefill_32k and decode_32k cells on ``params`` (and long_500k
    with ``long_seq``): prefill_32k, ``prefill_calls`` calls of
    ``make_prefill_step`` on one row of ``seq`` seeded tokens
    (``make_batch``, with a VLM's patch embeddings or Whisper's frames),
    the last timed, on the first ``prefill_layers`` layers where given
    (``cut_depth``); decode_32k, ``decode_steps`` steps of
    ``make_serve_step`` from a cache that ``seed_cache`` makes for
    ``decode_batch`` slots of ``seq``, so that the last step is at
    position ``seq - 1``, each step's argmax the next token, the steps
    after the first timed; long_500k the same at one slot of
    ``long_seq``.  Each cell's logits must be f32, finite and of its
    shape, its launches ``cell_launches`` per call or step on the card
    (none on the CPU), and a decode cell must end at its family's own
    position ``seq`` (``cache_positions``; xLSTM has none) with a finite
    recurrent state.  Returns each cell's ms, runs, launches, peak memory
    and cuts."""
    cfg, device = model.cfg, model.device
    on_card = device.type == "cuda"
    gen = torch.Generator(device).manual_seed(32)
    full = get_arch(cfg.name).n_layers
    out = {}

    def run(kind, shape, fn, runs, run_cfg, length):
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        times, logits = [], None
        for _ in range(runs):
            del logits          # one (B, S, V) f32 tensor at a time
            sync(device)
            t0 = time.perf_counter()
            logits = fn()
            sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        launches = launch_counts()
        want = {k: n * runs for k, n in
                cell_launches(run_cfg, kind, length).items()} \
            if on_card else {}
        if tuple(logits.shape) != shape or logits.dtype != torch.float32 \
                or not all_finite(logits):
            raise AssertionError(f"{kind} cell: bad logits "
                                 f"{tuple(logits.shape)} {logits.dtype}")
        if {k: n for k, n in launches.items() if n} != want:
            raise AssertionError(f"{kind} cell launched {launches}, want "
                                 f"{want}")
        return {"runs": runs, "ms_all": times, "launches": launches,
                "peak_GB": (torch.cuda.max_memory_allocated(device) / 1e9
                            if on_card else None)}

    pmodel, pparams = (cut_depth(model, params, prefill_layers)
                       if prefill_layers else (model, params))
    batch = pmodel.make_batch(gen, ShapeConfig("prefill_32k", "prefill",
                                               seq, 1))
    prefill = make_prefill_step(pmodel)
    res = run("prefill", (1, seq, cfg.vocab),
              lambda: prefill(pparams, batch), prefill_calls, pmodel.cfg,
              seq)
    res.update(batch=1, seq=seq, ms=res["ms_all"][-1],
               cuts={"batch": f"{SHAPES['prefill_32k'].global_batch} -> 1",
                     "layers": f"{pmodel.cfg.n_layers} of {full} layers"})
    out["prefill_32k"] = res
    del batch, pmodel, pparams
    step = make_serve_step(model)
    cells = [("decode_32k", decode_batch, seq)]
    if long_seq:
        cells.append(("long_500k", 1, long_seq))
    for name, b, length in cells:
        state = {"cache": seed_cache(model, params, b, length, decode_steps,
                                     warm_steps, gen),
                 "tokens": torch.randint(0, cfg.vocab, (b, 1), generator=gen,
                                         device=device, dtype=torch.int32)}

        def one_step(state=state):
            logits, state["cache"] = step(params, state["cache"],
                                          state["tokens"])
            state["tokens"] = logits[:, -1].argmax(-1, keepdim=True).int()
            return logits

        res = run("decode", (b, 1, cfg.vocab), one_step, decode_steps, cfg,
                  length)
        positions = cache_positions(state["cache"])
        if any(p != length for p in positions):
            raise AssertionError(f"{name} cell ended at pos {positions}, "
                                 f"not {length}")
        if not all(all_finite(t) for t in recurrent_state(state["cache"])):
            raise AssertionError(f"{name} cell: its recurrent state is not "
                                 f"finite")
        shape = SHAPES[name]
        cuts = {"layers": f"{cfg.n_layers} of {full} layers"}
        if b != shape.global_batch:
            cuts["batch"] = f"{shape.global_batch} -> {b}"
        res.update(batch=b, seq=length, first_pos=length - decode_steps,
                   position=positions[0] if positions else None,
                   ms=statistics.median(res["ms_all"][1:] or res["ms_all"]),
                   cuts=cuts)
        out[name] = res
        del state
    for name, res in out.items():
        print(f"{name} cell, {cfg.name}:", json.dumps(res))
    return out


def seed_cache(model, params: dict, batch: int, seq: int, steps: int,
               warm_steps: int, gen) -> dict:
    """A decode cell's cache for ``batch`` slots of ``seq`` whose next
    ``steps`` steps end at position ``seq - 1``: ``init_cache``; where the
    family carries a recurrent state (``recurrent_state``: Hymba's Mamba h
    and conv, xLSTM's mLSTM and sLSTM states), ``warm_steps`` steps of
    ``make_serve_step`` on seeded tokens, so that the model itself makes
    it; then every K and V (a dense cache, Hymba's ring, Whisper's self
    and cross caches) drawn from ``gen`` and each position set to
    ``seq - steps``."""
    cache = model.init_cache(batch, seq)
    if recurrent_state(cache):
        step = make_serve_step(model)
        tokens = torch.randint(0, model.cfg.vocab, (batch, warm_steps),
                               generator=gen, device=model.device,
                               dtype=torch.int32)
        for i in range(warm_steps):
            _, cache = step(params, cache, tokens[:, i:i + 1])
    for kv in kv_caches(cache):
        for name in ("k", "v"):
            kv[name].normal_(generator=gen)
    for holder in _walk(cache):
        if "pos" in holder:
            holder["pos"] = seq - steps
    return cache


def _walk(tree):
    """Every dict in a cache tree, the tree's own first."""
    if isinstance(tree, dict):
        yield tree
        for v in tree.values():
            yield from _walk(v)


def kv_caches(cache: dict) -> list:
    """The dicts of a cache tree that hold K and V tensors."""
    return [d for d in _walk(cache) if "k" in d and "v" in d]


def cache_positions(cache: dict) -> list:
    """Every position a cache tree holds (one for a dense cache, Hymba's
    ring and Whisper's self cache; none for xLSTM's states)."""
    return [d["pos"] for d in _walk(cache) if "pos" in d]


def recurrent_state(cache: dict) -> list:
    """The tensors of a cache tree that are neither K and V nor a
    position: Hymba's Mamba h and conv, xLSTM's states."""
    held = {id(d[n]) for d in kv_caches(cache) for n in ("k", "v")}
    return [v for d in _walk(cache) for v in d.values()
            if isinstance(v, torch.Tensor) and id(v) not in held]


def cut_depth(model, params: dict, n_layers: int):
    """(model, parameters) of ``model`` cut to its first ``n_layers``
    layers: a model of ``cfg.scaled(n_layers=...)`` and views of the
    stacked leaves' first layers (``param_specs`` says which)."""
    cut = build_model(model.cfg.scaled(n_layers=n_layers),
                      device=model.device)

    def take(p, spec):
        return p[:spec.shape[0]] if tuple(p.shape) != tuple(spec.shape) \
            else p

    return cut, _map2(take, params, cut.param_specs())


def _map2(fn, a, b):
    return ({k: _map2(fn, a[k], b[k]) for k in a} if isinstance(a, dict)
            else fn(a, b))


def all_finite(t: torch.Tensor, rows: int = 4096) -> bool:
    """Whether every element of ``t`` is finite, ``rows`` rows of its last
    dimension at a time: ``torch.isfinite`` of a whole (1, 32768, V) f32
    logits tensor takes an f32 ``abs`` of it and two bool tensors besides,
    26 GB at Grok-1's vocabulary (derived)."""
    return all(bool(torch.isfinite(part).all())
               for part in t.reshape(-1, t.shape[-1]).split(rows))


def cell_launches(cfg, kind: str, seq: int) -> dict:
    """Kernel launches of one ``make_prefill_step`` call (``kind``
    "prefill", ``seq`` tokens a row) or one ``make_serve_step`` step
    ("decode") of ``cfg``'s model: ``launches_per_call``'s flash
    attentions a prefill call or flash decodes a step (none for xLSTM),
    and for MoE three grouped matmuls a layer and MoE chunk
    (``n_chunks(seq)`` in the prefill, one in a step)."""
    L = cfg.n_layers
    attn, decode = launches_per_call(cfg)
    n = attn if kind == "prefill" else decode
    out = {"flash_attention" if kind == "prefill" else "flash_decode": n} \
        if n else {}
    if cfg.n_experts:
        out["grouped_matmul"] = 3 * L * (n_chunks(seq) if kind == "prefill"
                                         else 1)
    return out


def serving_config(phase: str) -> ArchConfig:
    """The config of a serving phase that runs the 32k cells: Qwen3-4B
    whole (phase 7), Grok-1 at ``MOE_LAYERS`` (11), Kimi-K2 at
    ``KIMI_LAYERS`` (13), Hymba, xLSTM and Whisper whole (D, E, F), and
    each of ``CONFIG_PHASES`` at its depth."""
    if phase == "7":
        return get_arch(ARCH)
    if phase == "11":
        return get_arch(MOE_ARCH).scaled(n_layers=MOE_LAYERS)
    if phase == "13":
        return get_arch(KIMI_ARCH).scaled(n_layers=KIMI_LAYERS)
    if phase in FAMILY_PHASES:
        return get_arch(FAMILY_PHASES[phase][0])
    arch, layers, _ = CONFIG_PHASES[phase]
    cfg = get_arch(arch)
    return cfg.scaled(n_layers=layers or cfg.n_layers)


def cell_sizes(phase: str) -> dict:
    """``drive_cells``' sizes for a serving phase: its decode_32k batch
    (``DECODE_32K_BATCH`` or ``FAMILY_CELL_BATCH``), long_500k's context
    where it runs that cell, prefill_32k's depth where it is cut."""
    sizes = {"decode_batch": {**DECODE_32K_BATCH,
                              **FAMILY_CELL_BATCH}[phase]}
    if phase in LONG_CELL_PHASES:
        sizes["long_seq"] = LONG_500K
    if phase in CELL_PREFILL_LAYERS:
        sizes["prefill_layers"] = CELL_PREFILL_LAYERS[phase]
    return sizes


def decode_32k_batch(cfg) -> int:
    """decode_32k's batch on the card for ``cfg`` at its depth run: the
    reference's 128, halved until the bf16 weights and each slot's cache
    for a 32,768-token context (the model's own ``cache_specs``: a dense
    model's k and v over 32,768 tokens, Hymba's ring and Mamba state,
    xLSTM's states, Whisper's self and cross caches) leave ``CARD_FREE``
    of ``CARD_GB`` free (derived from the shapes)."""
    model = build_model(cfg, device="cpu")
    weights = 2 * count_params(model.param_specs())
    slot = cache_bytes(model.cache_specs(1, SEQ_32K))
    budget = (1 - CARD_FREE) * CARD_GB * 1e9
    batch = SHAPES["decode_32k"].global_batch
    while batch > 1 and weights + batch * slot > budget:
        batch //= 2
    return batch


def cache_bytes(specs: dict) -> int:
    """Bytes of a cache spec's tensors but its positions."""
    return sum(t.numel() * t.element_size() for d in _walk(specs)
               for k, t in d.items()
               if k != "pos" and isinstance(t, torch.Tensor))


def batch_extras(model, batch: int, seq: int, seed: int = 1) -> dict:
    """A prefill or train batch's inputs other than its tokens, from the
    model's ``make_batch`` with a seeded generator on its device:
    Whisper's frames (B, 1500, d_model); nothing for the decoder-only
    families."""
    made = model.make_batch(torch.Generator(model.device).manual_seed(seed),
                            ShapeConfig("prefill", "prefill", seq, batch))
    return {k: v for k, v in made.items() if k != "tokens"}


def launches_per_call(cfg) -> tuple:
    """(flash-attention launches per prefill call, flash-decode launches
    per engine step) of a family's serving path: one of each a layer; for
    Whisper one per encoder layer and two per decoder layer (self and
    cross) in the prefill and two per decoder layer in decode; none for
    xLSTM, which reaches no kernel."""
    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "audio":
        return cfg.enc_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    return cfg.n_layers, cfg.n_layers


def check_serving_launches(run: dict, n_layers: int, on_card: bool,
                           per_call: tuple = None) -> None:
    """The kernels of the path ran: ``n_layers`` flash-attention launches
    per prefill call and ``n_layers`` flash-decode launches per engine
    step (``per_call`` gives the two counts where they differ, as
    ``launches_per_call``; none on the CPU), and no crop launch; for an
    MoE model also 3 grouped-matmul launches per layer and MoE chunk of a
    prefill call and per layer of an engine step."""
    per = n_layers if on_card else 0
    attn_per, decode_per = per_call if per_call and on_card else (per, per)
    gmm = 3 * per if run["is_moe"] else 0
    calls, steps = run["prefill_calls"], run["engine_steps"]
    want_prefill = {"crop_mirror_normalize": 0,
                    "flash_attention": attn_per * calls, "flash_decode": 0,
                    "grouped_matmul": gmm * n_chunks(run["prefill_s"])
                    * calls}
    want = dict(want_prefill, flash_decode=decode_per * steps,
                grouped_matmul=want_prefill["grouped_matmul"] + gmm * steps)
    if run["after_prefill"] != want_prefill or run["launches"] != want:
        raise AssertionError(f"launches {run['after_prefill']} after the "
                             f"prefill and {run['launches']} after the "
                             f"engine; want {want_prefill} and {want}")


class Pending:
    """An f32 check whose CPU side runs in the f32 worker while the card
    goes on: ``ready`` says whether the worker has answered; ``collect``
    re-raises the worker's exception, or finishes the check on the CPU
    side's result (``finish``, which raises on a miss), once, and returns
    its result."""

    def __init__(self, name: str, future, finish) -> None:
        self.name, self.future, self.finish = name, future, finish
        self.result = None

    def ready(self) -> bool:
        return self.future.done()

    def collect(self):
        if self.result is None:
            self.result = self.finish(self.future.result())
        return self.result


def submit(pool, fn, *args) -> concurrent.futures.Future:
    """``fn(*args)`` in ``pool`` (the f32 workers), or in line, done,
    where ``pool`` is None.  A pool holds each call's arguments (a
    model's f32 weights, up to 13 GB) until its result is back, so a
    call waits while ``F32_QUEUED`` are outstanding."""
    if pool is None:
        done = concurrent.futures.Future()
        done.set_result(fn(*args))
        return done
    outstanding = [f for f in _SUBMITTED.setdefault(id(pool), [])
                   if not f.done()]
    if len(outstanding) >= F32_QUEUED:
        t0 = time.perf_counter()
        concurrent.futures.wait(outstanding,
                                return_when=concurrent.futures.FIRST_COMPLETED)
        print(f"f32 workers: waited {time.perf_counter() - t0!r} s for a "
              f"place in the queue")
    future = pool.submit(fn, *args)
    _SUBMITTED[id(pool)] = outstanding + [future]
    return future


_SUBMITTED = {}


def pending(name: str, future, finish, pool):
    """A ``Pending`` check, or with no pool its result at once."""
    check = Pending(name, future, finish)
    return check if pool is not None else check.collect()


def check_f32_path(device, cfg, prompts, *, prefill_len: int = CHECK_PREFILL,
                   n_steps: int = CHECK_STEPS, slots: int = SLOTS,
                   max_seq: int = CHECK_MAX_SEQ,
                   new_tokens: int = NEW_TOKENS, pool=None):
    """Phase 8: the serving path in f32 on the same weights, once on
    ``device`` and once through the port on the CPU (the kernels' plain
    versions): logits of a 1 x prefill_len prefill (with the
    ``batch_extras`` the family takes, made once) and of the first
    ``n_steps`` engine steps (``f32_path_side``).  The weights are drawn
    on ``device`` and cross to the CPU side in shared memory
    (``shared``).  With ``pool`` (the f32 workers) the CPU side runs there
    (``f32_path_cpu``) while the card goes on, and a ``Pending`` is
    returned; without, the check runs in line and returns its result.
    TF32 is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = build_model(cfg, device=device).init(
        torch.Generator(device).manual_seed(0))
    cpu = torch.device("cpu")
    batch = dict(batch_extras(build_model(cfg, device=cpu), 1,
                                prefill_len),
                 tokens=torch.from_numpy(
                     np.concatenate(prompts)[:prefill_len][None]))
    sizes = dict(n_steps=n_steps, slots=slots, max_seq=max_seq,
                 new_tokens=new_tokens)
    cpu_side = submit(pool, f32_path_cpu, cfg, shared(params, pool), batch,
                      prompts, sizes)
    card_prefill, card_steps, card_launches = f32_path_side(
        device, cfg, params, batch, prompts, **sizes)
    del params
    print(f"f32 path of {cfg.name}, launches on the card:",
          json.dumps(card_launches))

    def finish(cpu_run: dict) -> dict:
        out = {"prefill_max_abs_diff":
               float((card_prefill - cpu_run["prefill"]).abs().max()),
               "decode_max_abs_diff":
               float((card_steps - cpu_run["steps"]).abs().max())}
        print(f"f32 path of {cfg.name}, card vs CPU (its CPU side "
              f"{cpu_run['seconds']!r} s):", json.dumps(out))
        if not max(out.values()) <= CHECK_TOL:
            raise AssertionError(f"the card's f32 logits differ from the CPU "
                                 f"port's by more than {CHECK_TOL}: {out}")
        return out

    return pending(f"f32 path of {cfg.name}", cpu_side, finish, pool)


def f32_path_side(device, cfg, params, batch: dict, prompts, *,
                  n_steps: int, slots: int, max_seq: int,
                  new_tokens: int) -> tuple:
    """One side of ``check_f32_path`` on ``device``: the prefill's logits
    and the first ``n_steps`` engine steps' logits (on the CPU) and the
    kernels' launches."""
    reset_launches()
    model = build_model(cfg, device=device)
    logits = make_prefill_step(model)(
        params, {k: v.to(device) for k, v in batch.items()})
    engine = ServingEngine(model, params, ServeConfig(
        batch_slots=slots, max_seq=max_seq, max_new_tokens=new_tokens))
    for prompt in prompts:
        engine.submit(prompt)
    steps = []
    for _ in range(n_steps):
        engine.step()
        steps.append(engine.last_logits.cpu())
    return logits.cpu(), torch.stack(steps), launch_counts()


def f32_path_cpu(cfg, params: dict, batch: dict, prompts,
                 sizes: dict) -> dict:
    """``check_f32_path``'s CPU side (in an f32 worker): the port on the
    CPU on ``params`` and ``batch`` (CPU tensors).  Returns its logits and
    its seconds."""
    t0 = time.perf_counter()
    prefill, steps, _ = f32_path_side(torch.device("cpu"), cfg, params,
                                      batch, prompts, **sizes)
    return {"prefill": prefill, "steps": steps,
            "seconds": time.perf_counter() - t0}


def shared(tree: dict, pool) -> dict:
    """A tree of tensors for an f32 check's CPU side: with a pool, a copy
    on the CPU in shared memory, which crosses to a worker as a handle
    (a pipe would carry its bytes under the GIL, a chunk at a time,
    while the card's phases hold it); without, a copy on the CPU (the
    card side may update its own in place)."""
    def leaf(t):
        out = torch.empty(t.shape, dtype=t.dtype)
        if pool is not None:
            out.share_memory_()
        return out.copy_(t)

    return tree_map(leaf, tree)


def drive_family(device, cfg, serve: dict, check: dict,
                 cells: dict = None, pool=None) -> dict:
    """Phases 13, D, E, F and L-O: a family's serving path through
    ``drive_serving`` (with the 32k cells where ``cells`` gives their
    sizes) with ``launches_per_call``'s exact launch counts (none on the
    CPU), then ``check_f32_path`` on ``cfg`` in f32 with ``check``'s cuts
    and sizes (``n_layers``, ``d_ff``, and ``prompt``: one prompt of that
    many of the served prompts' tokens), its CPU side in ``pool`` where
    given (``"f32"`` is then a ``Pending``); the card is freed after each.
    Prints and returns the phase's seconds on the card with both
    results."""
    t0 = time.perf_counter()
    run, prompts = drive_serving(device, cfg, **serve, cells=cells)
    check_serving_launches(run, cfg.n_layers, device.type == "cuda",
                           launches_per_call(cfg))
    free_card()
    sizes = dict(check)
    cut = {k: sizes.pop(k) for k in ("n_layers", "d_ff") if k in sizes}
    if "prompt" in sizes:
        prompts = [np.concatenate(prompts)[:sizes.pop("prompt")]]
    f32 = check_f32_path(device, cfg.scaled(dtype="float32", **cut),
                         prompts, **sizes, pool=pool)
    free_card()
    out = {"run": run, "f32": f32, "seconds": time.perf_counter() - t0}
    print(f"phase {cfg.name}: {out['seconds']!r} s")
    return out


def attention_bound(kind: str, B: int, H: int, K: int, S: int, T: int,
                    D: int, elsize: int, causal: bool = True,
                    window: int = 0):
    """Least time for a flash-attention call (``cost.attention_work``)."""
    flops, nbytes = cost.attention_work(B, H, K, S, T, D, elsize, causal,
                                        window)
    return _bound(kind, nbytes, flops, elsize)


def decode_bound(kind: str, lengths, K: int, G: int, D: int, elsize: int):
    """Least time for a flash-decode call (``cost.decode_work``)."""
    flops, nbytes = cost.decode_work(lengths, K, G, D, elsize)
    return _bound(kind, nbytes, flops, elsize)


def _bound(kind: str, nbytes: int, flops: int, elsize: int):
    ms, by = cost.roof(kind, nbytes, flops, cost.elsize_key(elsize))
    return nbytes, flops, ms, by


def time_attention(device, kind: str) -> dict:
    """Phase 9: each attention kernel's device ms per launch, the host's ms
    per call, its plain version's ms and one PyTorch call's ms
    (``scaled_dot_product_attention``, timed only) at the timed shapes:
    ``TIME_ATTENTION`` in bf16, ``TIME_ATTENTION_32K`` in bf16 (the plain
    version one kv group at a time over every group, timed once; SDPA on
    any backend but the math one), ``TIME_MASKED_ATTENTION`` in bf16 and
    ``TIME_ATTENTION_32K_FAMILY`` in bf16 as ``TIME_ATTENTION_32K`` with
    their masks (SDPA given Hymba's window as a boolean mask over repeated
    kv heads), ``TIME_ATTENTION_F32`` in f32 with their masks (SDPA given the same
    mask as a boolean ``attn_mask``, or ``is_causal`` for a causal S = T
    without a window), ``TIME_DECODES`` in bf16, at
    the full cache and at ``DECODE_LIVE``'s live lengths, and
    ``TIME_DECODE_F32`` in f32 at the full cache.  Each bf16 decode row
    also times the CUDA-core decode kernel on the same inputs
    (``cuda_core_ms``), gives the tensor-core kernel's split and how many
    of its clusters the card holds at once, and times the kernel, the
    CUDA-core kernel and SDPA replayed from a CUDA graph as well
    (``*graph_ms``: device time without the host's gaps)."""
    gen = torch.Generator(device).manual_seed(9)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    out = {}
    dtype = torch.bfloat16
    for label, (B, H, K, S, D) in TIME_ATTENTION:
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
    rows_32k = [(label, (B, H, K, S, S, D), True, 0)
                for label, (B, H, K, S, D) in TIME_ATTENTION_32K]
    for label, (B, H, K, S, T, D), causal, window in \
            rows_32k + TIME_ATTENTION_32K_FAMILY:
        q = randn((B, S, H, D), dtype).transpose(1, 2)
        k, v = (randn((B, T, K, D), dtype).transpose(1, 2) for _ in "kv")
        mask = k_h = v_h = None
        if window:
            keep = (torch.arange(S, device=device)[:, None]
                    - torch.arange(T, device=device)[None, :])
            mask = (keep >= 0) & (keep < window)
            del keep
            # the memory-efficient and cuDNN backends take a mask but not
            # GQA: the kv heads repeated beforehand, outside the timing
            k_h, v_h = (t.repeat_interleave(H // K, 1) for t in (k, v))

        def kernel(q=q, k=k, v=v, causal=causal, window=window):
            return ops.flash_attention(q, k, v, causal=causal, window=window)

        def plain(q=q, k=k, v=v, K=K, causal=causal, window=window,
                  heads=plain_heads(H // K, S, T)):
            for _ in grouped_reference(q, k, v, range(K), causal=causal,
                                       window=window, heads=heads):
                pass

        def sdpa(q=q, k=k, v=v, causal=causal, mask=mask, k_h=k_h,
                 v_h=v_h):
            # Not the math backend, whose (B,H,S,T) scores do not fit.
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION,
                              SDPBackend.EFFICIENT_ATTENTION]):
                if mask is not None:
                    return F.scaled_dot_product_attention(
                        q, k_h, v_h, attn_mask=mask)
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)

        nbytes, flops, bound_ms, bound_by = attention_bound(
            kind, B, H, K, S, T, D, 2, causal, window)
        row = {"shape": [B, H, K, S, D]} if (T, causal, window) == (
            S, True, 0) else {"shape": [B, H, K, S, T, D], "causal": causal,
                              "window": window}
        out[label] = dict(
            row, ms=median_event_ms(kernel, n=2, repeats=5),
            host_ms_per_call=median_host_ms(kernel, n=2, repeats=3),
            plain_ms=median_event_ms(plain, n=1, repeats=1, warmup=0),
            library_ms=median_event_ms(sdpa, n=2, repeats=5),
            bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, mask, k_h, v_h, kernel, plain, sdpa
    for label, (B, H, K, S, T, D), causal, window in TIME_MASKED_ATTENTION:
        q = randn((B, S, H, D), dtype).transpose(1, 2)
        k, v = (randn((B, T, K, D), dtype).transpose(1, 2) for _ in "kv")
        keep = (torch.arange(S, device=device)[:, None]
                - torch.arange(T, device=device)[None, :])
        mask = ((keep >= 0) if causal else torch.ones_like(keep, dtype=bool))
        if window:
            mask &= keep < window

        def kernel(q=q, k=k, v=v, causal=causal, window=window):
            return ops.flash_attention(q, k, v, causal=causal, window=window)

        def sdpa(q=q, k=k, v=v, mask=mask):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)

        nbytes, flops, bound_ms, bound_by = attention_bound(
            kind, B, H, K, S, T, D, 2, causal, window)
        out[label] = {
            "shape": [B, H, K, S, T, D], "causal": causal, "window": window,
            "ms": median_event_ms(kernel, n=5, repeats=10),
            "host_ms_per_call": median_host_ms(kernel, n=5, repeats=10),
            "plain_ms": median_event_ms(
                lambda: ref.mha_reference(q, k, v, causal=causal,
                                          window=window), n=2, repeats=3),
            "library_ms": median_event_ms(sdpa, n=5, repeats=10),
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
            "bound_by": bound_by}
        del q, k, v, mask
    dtype = torch.float32
    for label, (B, H, K, S, T, D), causal, window in TIME_ATTENTION_F32:
        q = randn((B, S, H, D), dtype).transpose(1, 2)
        k, v = (randn((B, T, K, D), dtype).transpose(1, 2) for _ in "kv")
        keep = (torch.arange(S, device=device)[:, None]
                - torch.arange(T, device=device)[None, :])
        mask = ((keep >= 0) if causal else torch.ones_like(keep, dtype=bool))
        if window:
            mask &= keep < window

        def kernel(q=q, k=k, v=v, causal=causal, window=window):
            return ops.flash_attention(q, k, v, causal=causal, window=window)

        def sdpa(q=q, k=k, v=v, mask=mask, causal=causal and not window
                 and S == T):
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=None if causal else mask,
                is_causal=causal, enable_gqa=True)

        nbytes, flops, bound_ms, bound_by = attention_bound(
            kind, B, H, K, S, T, D, 4, causal, window)
        out[label] = {
            "shape": [B, H, K, S, T, D], "causal": causal, "window": window,
            "block_q": flash_attention.plan(B, H, S, D, dtype).block_q,
            "ms": median_event_ms(kernel, n=3, repeats=5),
            "host_ms_per_call": median_host_ms(kernel, n=3, repeats=5),
            "plain_ms": median_event_ms(
                lambda: ref.mha_reference(q, k, v, causal=causal,
                                          window=window), n=1, repeats=3),
            "library_ms": median_event_ms(sdpa, n=3, repeats=5),
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
            "bound_by": bound_by}
        del q, k, v, mask
    dtype = torch.bfloat16
    decode_rows = [(name, shape, shape[3]) for name, shape in TIME_DECODES]
    decode_rows += [(f"{name} live {DECODE_LIVE[shape]}", shape,
                     DECODE_LIVE[shape]) for name, shape in TIME_DECODES
                    if DECODE_LIVE.get(shape, shape[3]) != shape[3]]
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
        reps = dict(n=5, repeats=5) \
            if 2 * k.numel() * k.element_size() > DECODE_TIME_BIG else {}
        out[name] = {
            "shape": [b, K, G, t, D], "length": n,
            "ms": median_event_ms(kernel, **reps),
            "graph_ms": median_graph_ms(kernel, **reps),
            "host_ms_per_call": median_host_ms(kernel, **reps),
            "cuda_core_ms": median_event_ms(cuda_core, **reps),
            "cuda_core_graph_ms": median_graph_ms(cuda_core, **reps),
            "plain_ms": median_event_ms(
                lambda: ref.decode_reference(q.reshape(b, K * G, D), k, v,
                                             lengths), n=3, repeats=5),
            "library_ms": median_event_ms(sdpa, **reps),
            "library_graph_ms": median_graph_ms(sdpa, **reps),
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
            "bound_by": bound_by, "split": split,
            "clusters_held": decode_attention.max_active_clusters(D, split),
            "clusters_launched": b * K}
        del q, k, v
    name, (b, K, G, t, D) = TIME_DECODE_F32
    q = randn((b, K, G, D), torch.float32)
    k, v = (randn((b, t, K, D), torch.float32).transpose(1, 2) for _ in "kv")
    lengths = torch.full((b,), t, dtype=torch.int32, device=device)
    q_h = q.reshape(b, K * G, 1, D)
    nbytes, flops, bound_ms, bound_by = decode_bound(kind, [t] * b, K, G, D,
                                                     4)
    out[name] = {
        "shape": [b, K, G, t, D], "length": t,
        "ms": median_event_ms(lambda: ops.flash_decode(q, k, v, lengths)),
        "host_ms_per_call": median_host_ms(
            lambda: ops.flash_decode(q, k, v, lengths)),
        "plain_ms": median_event_ms(
            lambda: ref.decode_reference(q.reshape(b, K * G, D), k, v,
                                         lengths), n=3, repeats=5),
        "library_ms": median_event_ms(
            lambda: F.scaled_dot_product_attention(q_h, k, v,
                                                   enable_gqa=True)),
        "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
        "bound_by": bound_by}
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
    for E, C, d, f in GMM_REPEAT_CASES:
        x = randn((E, C, d), torch.bfloat16)
        w = randn((E, d, f), torch.bfloat16, d ** -0.5)
        first, second = ops.grouped_matmul(x, w), ops.grouped_matmul(x, w)
        if not torch.equal(first, second):
            raise AssertionError(f"gmm {(E, C, d, f)}: two launches on the "
                                 "same inputs differ")
        print(f"check gmm {(E, C, d, f)} bf16: two launches bit-identical")
        del x, w, first, second
    return path


def gmm_bound(kind: str, E: int, C: int, d: int, f: int, elsize: int):
    """Least time for a grouped-matmul call (``cost.gmm_work``)."""
    flops, nbytes = cost.gmm_work(E, C, d, f, elsize)
    return _bound(kind, nbytes, flops, elsize)


def time_gmm(device, kind: str) -> dict:
    """Phase 16: the grouped matmul's device ms per launch, the host's ms
    per call, its plain version's ms and ``torch.bmm``'s ms (timed only)
    at the MoE path's shapes (``TIME_GMM``) and off it (``GMM_OFF_PATH``),
    in bf16, and in f32 at ``TIME_GMM_F32`` (``torch.bmm`` without TF32),
    with w at the model's scale."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device).manual_seed(13)
    out = {}
    rows = [(*row, torch.bfloat16) for row in TIME_GMM + GMM_OFF_PATH]
    rows += [(*row, torch.float32) for row in TIME_GMM_F32]
    for name, (E, C, d, f), n, repeats, dtype in rows:
        x = torch.randn((E, C, d), generator=gen, dtype=dtype, device=device)
        w = torch.randn((E, d, f), generator=gen, dtype=dtype,
                        device=device).mul_(d ** -0.5)

        def kernel(x=x, w=w):
            return ops.grouped_matmul(x, w)

        nbytes, flops, bound_ms, bound_by = gmm_bound(kind, E, C, d, f,
                                                      x.element_size())
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


def active_params(cfg, params: dict) -> int:
    """Parameters a token passes through: all, or for MoE all but the
    experts' and ``top_k / n_experts`` of the experts'."""
    n = count_params(params)
    if not cfg.n_experts:
        return n
    experts = sum(params["blocks"]["moe"][k].numel()
                  for k in ("w_gate", "w_up", "w_down"))
    return n - experts + experts * cfg.top_k // cfg.n_experts


def train_flops(cfg, params: dict, B: int, S: int) -> int:
    """Operations of one train step, derived: 6 per (active) parameter and
    row it multiplies (forward, and a backward of twice the forward) plus
    each attention's 4*D per kept (query, key) pair and head, three times
    over.  A row is a token, or for Whisper's encoder and its
    cross-attention's k and v projections one of the ``enc_frames``
    frames.  The attention: causal in every layer of the decoder-only
    families, within the window where there is one (Hymba's 1024); none in
    xLSTM; in Whisper, the encoder's over all F x F frame pairs, the
    decoder's causal self-attention and S x F cross-attention.  Not
    counted: remat's second forward, the experts' capacity slack (their
    slots are capacity_factor times the routed pairs), the mLSTM's
    chunkwise products and the recurrences' elementwise work."""
    n = active_params(cfg, params)
    per_pair = 3 * 4 * B * cfg.n_heads * cfg.resolved_head_dim
    if cfg.family == "ssm":
        return 6 * n * B * S
    if cfg.family == "audio":
        F_ = cfg.enc_frames
        cross = params["dec_blocks"]["cross_attn"]
        framed = (count_params(params["enc_blocks"])
                  + count_params(params["enc_ln"])
                  + sum(cross[k].numel() for k in ("wk", "wv", "bv")))
        pairs = ((cfg.enc_layers or cfg.n_layers) * F_ * F_
                 + cfg.n_layers * (causal_pairs(S, S) + S * F_))
        return (6 * (n - framed) * B * S + 6 * framed * B * F_
                + per_pair * pairs)
    return (6 * n * B * S
            + per_pair * cfg.n_layers * causal_pairs(S, S, cfg.window))


def train_probes(params: dict) -> dict:
    """Views of weight matrices that a train step must move (updated in
    place), picked from the model's own tree: the embedding; for the
    families with stacked ``blocks`` the first layer's ``wq`` and the last
    layer's ``w_down`` (for MoE the router and expert 0's), and Hymba's
    first Mamba ``w_in``; for xLSTM's ``pairs`` the first mLSTM's ``wq``
    and the last sLSTM's ``r_gates``; for Whisper the first encoder
    layer's ``wq``, the last decoder layer's cross-attention ``wq`` and
    MLP ``w_out``.  (A norm scale of 1.0 may not move: a bf16 parameter
    keeps no f32 master copy, in the reference as here, and an update
    under half its ulp rounds away.)"""
    probes = {"embedding": params["embed"]["embedding"][:8]}
    if "blocks" in params:
        blocks = params["blocks"]
        probes["wq layer 0"] = blocks["attn"]["wq"][0, :8]
        if "moe" in blocks:
            probes["router last layer"] = blocks["moe"]["router"][-1]
            probes["w_down expert 0 last layer"] = \
                blocks["moe"]["w_down"][-1, 0, :8]
        else:
            probes["w_down last layer"] = blocks["mlp"]["w_down"][-1, :8]
        if "mamba" in blocks:
            probes["mamba w_in layer 0"] = blocks["mamba"]["w_in"][0, :8]
    if "pairs" in params:
        pairs = params["pairs"]
        probes["mlstm wq pair 0"] = pairs["mlstm"]["wq"][0, :8]
        probes["slstm r_gates last pair"] = \
            pairs["slstm"]["r_gates"][-1, 0, :8]
    if "enc_blocks" in params:
        enc, dec = params["enc_blocks"], params["dec_blocks"]
        probes["encoder wq layer 0"] = enc["attn"]["wq"][0, :8]
        probes["cross wq last layer"] = dec["cross_attn"]["wq"][-1, :8]
        probes["mlp w_out last layer"] = dec["mlp"]["w_out"][-1, :8]
    return {k: v.detach() for k, v in probes.items()}


def drive_training(device, kind: str, cfg, *, batch: int = TRAIN_B,
                   seq: int = TRAIN_S, steps: int = TRAIN_STEPS,
                   state_dtype: str = "float32",
                   count_flops: bool = True) -> dict:
    """Phases 14, C, G, I, J and K: the training path through the entry
    points a user calls: ``init_state`` (AdamW moments of
    ``state_dtype``), then ``run_training`` over the simulated WAN (token
    records fetched by ``build_stack``'s DeviceFeed on route high), or
    for Whisper ``train_with_frames``, with the kernels' launches counted
    (training runs none: it uses the plain attention and, for MoE, the
    expert einsums, as the reference trains with XLA ops).  With
    ``count_flops`` the last step runs under ``FlopCounterMode`` (phase
    H).  Raises on a loss or gradient norm that is not finite,
    ``train_probes`` that did not change, fewer steps than asked, or a
    peak above the card's memory."""
    model = build_model(cfg, device=device)
    opt_cfg = OptimizerConfig(total_steps=steps, state_dtype=state_dtype,
                              **TRAIN_OPT)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = init_state(model, opt_cfg, torch.Generator(device).manual_seed(0))
    sync(device)
    out = {"init_s": time.perf_counter() - t0, "batch": batch, "seq": seq,
           "layers": cfg.n_layers, "state_dtype": state_dtype,
           "opt_state_GB": sum(t.numel() * t.element_size() for t in
                               tree_leaves(state["opt"])) / 1e9}
    params = state["params"]
    n_params = count_params(params)
    probes = train_probes(params)
    before = {k: v.clone() for k, v in probes.items()}
    reset_launches()
    counted = LastStepFlops(steps) if count_flops else None
    t0 = time.perf_counter()
    if cfg.family == "audio":
        res = train_with_frames(model, state, opt_cfg, batch, seq, steps,
                                counted)
        compute_s = res["compute_s"]
        out["loader_MBps_virtual"] = res["loader_MBps_virtual"]
    else:
        store = KVStore()
        uuids = ingest(store, SyntheticTokenDataset(
            n_samples=16 * batch, seq_len=seq, vocab=cfg.vocab, seed=2))
        loader_cfg = LoaderConfig(batch_size=batch, route="high",
                                  materialize=True, seed=2)
        res = run_training(model, store, uuids, loader_cfg,
                           TrainLoopConfig(total_steps=steps, seq_len=seq,
                                           log_every=1), opt_cfg,
                           state=state, on_metrics=counted)
        compute_s = res["step_stats"].compute_s
        out.update(stall_frac=res["stats"]["stall_frac"],
                   goodput_sps=res["stats"]["goodput_sps"],
                   loader_MBps_virtual=res["loader_stats"].throughput(
                       skip=1) / 1e6)
    sync(device)
    out["run_s"] = time.perf_counter() - t0
    out["launches"] = launch_counts()
    out["step_flops"] = counted.flops if counted else None
    hist = res["history"]
    # the first step warms up and the last runs under the flop counter;
    # a single uncounted step is timed, warm-up and all
    timed = compute_s[1:-1] if counted else compute_s[1:]
    step_s = statistics.median(timed or compute_s)
    n_active = active_params(cfg, params)
    flops = train_flops(cfg, params, batch, seq)
    peak = PEAKS.get(kind)
    out.update({
        "params": n_params, "active_params": n_active,
        "steps": len(compute_s), "ms_per_step": step_s * 1e3,
        "ms_per_step_all": [c * 1e3 for c in compute_s],
        "tokens_per_s": batch * seq / step_s,
        "peak_GB": (torch.cuda.max_memory_allocated(device) / 1e9
                    if device.type == "cuda" else None),
        "losses": [r["loss"] for r in hist],
        "grad_norms": [r["grad_norm"] for r in hist],
        "flops_per_step_derived": flops,
        "bf16_peak_share_derived":
            flops / step_s / peak["bf16_flops"] if peak else None,
        "changed": {k: float((probes[k].float() - before[k].float()).abs()
                             .max()) for k in probes}})
    for key in ("moe_aux_loss", "moe_z_loss", "moe_dropped_frac"):
        if key in hist[0]:
            out[key] = [r[key] for r in hist]
    print(f"training path, {cfg.name}:", json.dumps(out))
    bad = [r for r in hist if not (np.isfinite(r["loss"])
                                   and np.isfinite(r["grad_norm"]))]
    if bad or len(hist) != steps or out["steps"] != steps:
        raise AssertionError(f"training: {len(hist)} of {steps} steps "
                             f"logged, {out['steps']} run, not finite: "
                             f"{bad}")
    if not all(v > 0 for v in out["changed"].values()):
        raise AssertionError(f"training left parameters unchanged: "
                             f"{out['changed']}")
    if any(out["launches"].values()):
        raise AssertionError(f"training launched kernels: {out['launches']}")
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory / 1e9
        if not out["peak_GB"] < total:
            raise AssertionError(f"training peaked at {out['peak_GB']} GB "
                                 f"of the card's {total} GB")
    return out


def train_with_frames(model, state: dict, opt_cfg, batch: int, seq: int,
                      steps: int, on_metrics=None) -> dict:
    """Phase K's loop, for a model that reads ``frames`` (Whisper), which
    ``run_training`` does not feed in either package: ``steps`` batches
    of (batch, seq) tokens fetched over the simulated WAN in one loader
    batch (``fetch_tokens``), each with the same frames from the model's
    ``make_batch`` (``batch_extras``), through ``make_train_step``.
    Returns the history (``step``, ``loss``, ``grad_norm``; each record
    passed to ``on_metrics`` as ``run_training`` passes it), each step's
    seconds (host clock around the synchronised step) and the loader's
    MB/s on the virtual clock."""
    device = model.device
    tokens, mbps = fetch_tokens(16 * batch, seq, model.cfg.vocab,
                                steps * batch, device, seed=2)
    extras = batch_extras(model, batch, seq, seed=2)
    step_fn = make_train_step(model, opt_cfg)
    history, compute_s = [], []
    for i, rows in enumerate(tokens.split(batch)):
        sync(device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, dict(extras, tokens=rows))
        sync(device)
        compute_s.append(time.perf_counter() - t0)
        rec = {"step": i + 1, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"])}
        history.append(rec)
        if on_metrics:
            on_metrics(rec)
    return {"history": history, "compute_s": compute_s,
            "loader_MBps_virtual": mbps}


class LastStepFlops:
    """``run_training``'s ``on_metrics`` hook: ``FlopCounterMode`` over
    the last of ``steps`` steps (entered after the record of the step
    before, left after its own); ``flops`` is its count (phase H)."""

    def __init__(self, steps: int) -> None:
        self.steps = steps
        self.mode = FlopCounterMode(display=False)
        self.flops = None

    def __call__(self, rec: dict) -> None:
        if rec["step"] == self.steps - 1:
            self.mode.__enter__()
        elif rec["step"] == self.steps:
            self.mode.__exit__(None, None, None)
            self.flops = self.mode.get_total_flops()


def check_train_vs_serving(model, params, tokens) -> dict:
    """Phase C: under ``torch.no_grad``, the model's training forward (the
    expert einsums and the plain attention) against its serving forward
    (the grouped-matmul and flash-attention kernels) on the same
    parameters and tokens on the card: logits within ``CHECK_TOL``, and
    the serving forward's launches exactly 3 x layers x chunks grouped
    matmuls and one flash attention a layer (none on the CPU, where the
    plain versions run)."""
    L, S = model.cfg.n_layers, tokens.shape[1]
    with torch.no_grad():
        want, want_aux = model.forward(params, tokens, train=True)
        sync(tokens.device)
        reset_launches()
        got, got_aux = model.forward(params, tokens)
        sync(tokens.device)
        launches = launch_counts()
    expect = {name: 0 for name in KERNELS}
    if tokens.device.type == "cuda":
        expect.update(grouped_matmul=3 * L * n_chunks(S), flash_attention=L)
    out = {"tokens": list(tokens.shape), "chunks": n_chunks(S),
           "launches": launches,
           "max_abs_diff": float((got - want).abs().max()),
           "aux_train": {k: float(v) for k, v in want_aux.items()},
           "aux_serve": {k: float(v) for k, v in got_aux.items()}}
    print(f"f32 MoE training forward vs serving forward on "
          f"{tokens.device}:", json.dumps(out))
    if launches != expect:
        raise AssertionError(f"serving forward launched {launches}, "
                             f"expected {expect}")
    if not (torch.isfinite(got).all() and out["max_abs_diff"] <= CHECK_TOL):
        raise AssertionError(f"serving logits differ from training logits "
                             f"by more than {CHECK_TOL}: {out}")
    return out


def check_f32_training(device, cfg, *, batch: int = TRAIN_CHECK_B,
                       seq: int = TRAIN_CHECK_S,
                       steps: int = TRAIN_CHECK_STEPS,
                       restart: bool = True, serving: bool = False,
                       state_dtype: str = "float32", keep: dict = None,
                       pool=None):
    """Phases 15, C, G, I, J and K: the train step in f32 on one state,
    once on ``device`` and once through the port on the CPU (with the
    ``batch_extras`` the family takes, Whisper's frames): the first step's
    gradients (each leaf within ``CHECK_TOL`` of its max |g|) and the loss
    of each of ``steps`` steps (within ``CHECK_TOL``), ``f32_train_side``
    on each.  The state is drawn on ``device`` and crosses to the CPU side
    in shared memory (``shared``).  With quantized
    moments (``state_dtype``), the moments after the first update too,
    where the two sides differ only by the gradients' last bits: each
    dequantized int8 value within one quantization step of its row plus
    ``CHECK_TOL`` of its leaf's max (the gradients' own allowance), an
    f32 moment (a factored ``vr``/``vc``, a vector's v) within
    ``CHECK_TOL`` of its max (``moment_err``).  The moments after the last step are reported
    (``moment_err_last``), not judged: an int8 v code that rounds to 0
    under a live m makes a step of about ``lr * m_hat / eps``, so codes
    one apart at the first update grow apart by the third.
    With ``serving``, the card's trained model then goes through
    ``check_train_vs_serving``.  With ``restart``, a restart on the card:
    ``run_training`` to a checkpoint and on from it gives the loss curve
    of the run without a stop.  With ``keep`` (a dict), the card's final
    state and its first-step gradients (as CPU tensors) are put there,
    under ``"state"`` and ``"grads"``.  With ``pool`` (the f32 workers) the
    CPU side runs there (``f32_train_cpu``) while the card goes on, and a
    ``Pending`` is returned; without, the check runs in line and returns
    its result.  A CPU side that ``submit_f32_training`` submitted ahead
    for the same config and sizes is taken instead, once the state drawn
    here is shown to be the one it shipped.  TF32 is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    key = (cfg, batch, seq, steps, state_dtype)
    opt_cfg, state, inputs = f32_train_inputs(device, *key)
    ahead = _AHEAD.pop(key, None) if pool is not None else None
    if ahead is None:
        cpu_side = submit(pool, f32_train_cpu, cfg, shared(state, pool),
                          inputs, opt_cfg, steps)
    else:
        cpu_side, drawn = ahead
        if not all(torch.equal(a, b) for a, b in
                   zip(fingerprint(state), drawn)):
            raise AssertionError(f"{cfg.name}: the f32 check's state is not "
                                 f"the one its CPU side was given")
    card = f32_train_side(device, cfg, state, inputs, opt_cfg, steps)
    del state
    if serving:
        served = check_train_vs_serving(card["model"], card["state"]["params"],
                                        card["tokens"])
    if keep is not None:
        keep.update(state=card["state"], grads=card["grads"])
    card_s = card["seconds"]
    card = {k: card[k] for k in ("losses", "grads", "first_opt", "opt")}
    rest = {}
    if restart:
        with tempfile.TemporaryDirectory() as tmp:
            rest["restart"] = check_restart(device, tmp)
        if rest["restart"]["max_abs_diff"] > CHECK_TOL:
            raise AssertionError(f"restart from a checkpoint changed the "
                                 f"loss curve: {rest['restart']}")
    if serving:
        rest["serving"] = served
    card_done_s = time.perf_counter() - t0

    def finish(cpu_run: dict) -> dict:
        grad_err = max(float((a - b).abs().max()
                             / b.abs().max().clamp_min(1e-30))
                       for a, b in zip(card["grads"], cpu_run["grads"]))
        out = {"card_losses": card["losses"],
               "cpu_losses": cpu_run["losses"],
               "loss_max_abs_diff": max(abs(a - b) for a, b in
                                        zip(card["losses"],
                                            cpu_run["losses"])),
               "grad_max_rel_diff": grad_err,
               "seconds": card_done_s, "card_s": card_s,
               "cpu_s": cpu_run["seconds"]}
        if state_dtype != "float32":
            out["state_dtype"] = state_dtype
            out["moment_err"] = moment_err(card["first_opt"],
                                           cpu_run["first_opt"])
            out["moment_err_last"] = moment_err(card["opt"], cpu_run["opt"])
        out.update(rest)
        print(f"f32 training of {cfg.name} at {cfg.n_layers} layers, d_ff "
              f"{cfg.d_ff}, {batch} x {seq}, card vs CPU:", json.dumps(out))
        if not (out["loss_max_abs_diff"] <= CHECK_TOL
                and grad_err <= CHECK_TOL):
            raise AssertionError(f"the card's f32 train step differs from "
                                 f"the CPU port's by more than {CHECK_TOL}: "
                                 f"{out}")
        err = out.get("moment_err")
        if err and not (err["int8_excess"] <= CHECK_TOL
                        and err["f32_rel"] <= CHECK_TOL):
            raise AssertionError(f"the card's {state_dtype} moments differ "
                                 f"from the CPU port's: {out['moment_err']}")
        return out

    return pending(f"f32 training of {cfg.name} ({state_dtype})", cpu_side,
                   finish, pool)


def f32_train_inputs(device, cfg, batch: int, seq: int, steps: int,
                     state_dtype: str) -> tuple:
    """An f32 train check's AdamW config, its state drawn on ``device``
    from seed 0 and its inputs on the CPU (tokens over the simulated WAN,
    the family's ``batch_extras``), each the same at every call."""
    opt_cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                              total_steps=steps, state_dtype=state_dtype)
    state = init_state(build_model(cfg, device=device), opt_cfg,
                       torch.Generator(device).manual_seed(0))
    tokens, _ = fetch_tokens(4 * batch, seq, cfg.vocab, batch, device,
                             seed=3)
    extras = batch_extras(build_model(cfg, device=torch.device("cpu")),
                          batch, seq, seed=3)
    return opt_cfg, state, dict(extras, tokens=tokens.cpu())


def f32_train_checks() -> list:
    """(config, sizes) of every f32 train check the card's phases run, as
    their phases derive them: phase 15's (Qwen3-4B at
    ``CHECK_LAYERS``), C's, G's for each of ``INT8_CHECK_STATES``, and
    I-K's."""
    checks = [(get_arch(ARCH).scaled(n_layers=CHECK_LAYERS,
                                     dtype="float32"), {}),
              (moe_check_config(moe_train_config()),
               dict(batch=MOE_TRAIN_CHECK_B, seq=MOE_TRAIN_CHECK_S))]
    checks += [(moe_check_config(int8_train_config()),
                dict(batch=MOE_TRAIN_CHECK_B, seq=INT8_CHECK_S,
                     state_dtype=sd)) for sd in INT8_CHECK_STATES]
    for arch, _, check in FAMILY_TRAIN.values():
        cut = dict(check)
        seq = cut.pop("seq")
        checks.append((family_train_config(arch).scaled(dtype="float32",
                                                        **cut),
                       dict(batch=1, seq=seq)))
    return checks


def submit_f32_training(device, pool) -> None:
    """Submit the CPU side of each of ``f32_train_checks`` to ``pool`` at
    once, so that the workers run them while the card serves; each state
    is drawn on ``device``, shipped and freed, and ``check_f32_training``
    draws it again (the same seed) for its card side and takes the CPU
    side submitted here."""
    t0 = time.perf_counter()
    for cfg, sizes in f32_train_checks():
        key = (cfg, sizes.get("batch", TRAIN_CHECK_B),
               sizes.get("seq", TRAIN_CHECK_S), TRAIN_CHECK_STEPS,
               sizes.get("state_dtype", "float32"))
        opt_cfg, state, inputs = f32_train_inputs(device, *key)
        _AHEAD[key] = (submit(pool, f32_train_cpu, cfg, shared(state, pool),
                              inputs, opt_cfg, TRAIN_CHECK_STEPS),
                       fingerprint(state))
        del state
    free_card()
    print(f"f32 training checks: {len(_AHEAD)} CPU sides submitted in "
          f"{time.perf_counter() - t0!r} s")


_AHEAD = {}


def fingerprint(tree: dict) -> list:
    """Some 64 elements of each leaf of a tree of tensors, on the CPU:
    two draws of one state from one seed on one device give equal
    ones."""
    return [t.detach().reshape(-1)[::max(1, t.numel() // 64)].cpu()
            for t in tree_leaves(tree)]


def f32_train_side(device, cfg, state: dict, inputs: dict, opt_cfg,
                   steps: int) -> dict:
    """One side of ``check_f32_training`` on ``device`` from ``state``
    (updated in place) and ``inputs`` (tokens and extras on the CPU): the
    first step as ``make_train_step`` takes it (``train_loss``, autograd,
    AdamW) with its gradients kept, the rest through ``make_train_step``.
    Returns the losses, the first step's gradients and the moments after
    the first update and after the last (on the CPU), the final state,
    the model, the tokens on ``device`` and its seconds."""
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    model = build_model(cfg, device=device)
    b = {k: v.to(device) for k, v in inputs.items()}
    tokens = b["tokens"]
    b["loss_mask"] = torch.ones(tokens.shape, device=device)
    leaves = tree_leaves(state["params"])
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = model.train_loss(state["params"], b)[0]
    grads = torch.autograd.grad(loss, leaves)
    losses = [float(loss.detach())]
    state["params"], state["opt"], _ = adamw_update(
        tree_unflatten(state["params"], list(grads)), state["opt"],
        state["params"], opt_cfg)
    first_opt = tree_map(lambda t: t.to(cpu, copy=True), state["opt"])
    grads = [g.to(cpu) for g in grads]
    step = make_train_step(model, opt_cfg)
    for _ in range(steps - 1):
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "grads": grads, "first_opt": first_opt,
            "opt": tree_map(lambda t: t.to(cpu), state["opt"]),
            "state": state, "model": model, "tokens": tokens,
            "seconds": time.perf_counter() - t0}


def f32_train_cpu(cfg, state: dict, inputs: dict, opt_cfg,
                  steps: int) -> dict:
    """``check_f32_training``'s CPU side (in an f32 worker): the port on
    the CPU from ``state`` (CPU tensors, updated in place).  Returns the
    losses, the first step's gradients and, for quantized moments, the
    moments after the first update and after the last, and its
    seconds."""
    t0 = time.perf_counter()
    side = f32_train_side(torch.device("cpu"), cfg, state, inputs, opt_cfg,
                          steps)
    quantized = opt_cfg.state_dtype != "float32"
    return {"losses": side["losses"], "grads": side["grads"],
            "first_opt": side["first_opt"] if quantized else None,
            "opt": side["opt"] if quantized else None,
            "seconds": time.perf_counter() - t0}


def moment_err(a: dict, b: dict) -> dict:
    """How far two optimizer states' moments are apart: for the int8
    ones, the largest difference of codes and the largest excess of a
    dequantized value's difference over one quantization step of its row
    (the larger scale), relative to its leaf's max; for the f32 ones (a
    factored ``vr``/``vc``, a vector's v), the largest difference
    relative to its leaf's max."""
    err = {"int8_codes": 0, "int8_excess": 0.0, "f32_rel": 0.0}

    def walk(x, y):
        if isinstance(x, dict) and set(x) == {"q", "scale"}:
            da, db = (t["q"].float() * t["scale"] for t in (x, y))
            step = torch.maximum(x["scale"], y["scale"])
            err["int8_codes"] = max(err["int8_codes"], int(
                (x["q"].int() - y["q"].int()).abs().max()))
            err["int8_excess"] = max(err["int8_excess"], float(
                ((da - db).abs() - step).clamp_min(0).max()
                / db.abs().max().clamp_min(1e-30)))
        elif isinstance(x, dict):
            for k in x:
                walk(x[k], y[k])
        else:
            err["f32_rel"] = max(err["f32_rel"], float(
                (x - y).abs().max() / y.abs().max().clamp_min(1e-30)))

    walk(a["m"], b["m"])
    walk(a["v"], b["v"])
    return err


def drive_moe_training(device, kind: str, pool=None) -> dict:
    """Phase C: Grok-1 at full width (``MOE_TRAIN_LAYERS`` of its layers)
    trained through ``drive_training``, then its f32 check at
    ``MOE_TRAIN_CHECK_D_FF`` and ``MOE_TRAIN_CHECK_VOCAB`` with the
    training forward held against the serving forward (its CPU side in
    ``pool`` where given)."""
    cfg = moe_train_config()
    run = drive_training(device, kind, cfg, batch=MOE_TRAIN_B,
                         seq=MOE_TRAIN_S)
    free_card()
    check = check_f32_training(
        device, moe_check_config(cfg), batch=MOE_TRAIN_CHECK_B,
        seq=MOE_TRAIN_CHECK_S, restart=False, serving=True, pool=pool)
    return {"run": run, "check": check}


def moe_train_config() -> ArchConfig:
    """Phase C's model: Grok-1 at full width, ``MOE_TRAIN_LAYERS`` of its
    layers, with remat."""
    return get_arch(MOE_ARCH).scaled(n_layers=MOE_TRAIN_LAYERS, remat=True)


def family_train_config(arch: str) -> ArchConfig:
    """A phase I-K model: ``arch``'s config at full width, whole or at
    its depth in ``FAMILY_TRAIN_LAYERS``, with remat."""
    cfg = get_arch(arch)
    return cfg.scaled(n_layers=FAMILY_TRAIN_LAYERS.get(arch, cfg.n_layers),
                      remat=True)


def drive_family_training(device, kind: str, cfg, sizes: dict,
                          check: dict, pool=None) -> dict:
    """Phases I, J and K: ``cfg`` trained through ``drive_training`` with
    ``sizes``; for xLSTM also the derived ms per sLSTM step and layer (ms
    per step over seq x pairs: an upper bound, as it holds the rest of
    the step too); the card freed; then ``check_f32_training`` on ``cfg``
    in f32 with ``check``'s cut (``n_layers``) on one row of ``check``'s
    ``seq`` tokens, without the restart, its CPU side in ``pool`` where
    given.  Prints and returns the phase's seconds on the card with both
    results."""
    t0 = time.perf_counter()
    run = drive_training(device, kind, cfg, **sizes)
    if cfg.family == "ssm":
        run["ms_per_slstm_step_layer_derived"] = run["ms_per_step"] / (
            run["seq"] * (cfg.n_layers // 2))
        print(f"training path, {cfg.name}: ms per sLSTM step and layer "
              f"(derived) {run['ms_per_slstm_step_layer_derived']!r}")
    free_card()
    cut = dict(check)
    seq = cut.pop("seq")
    f32 = check_f32_training(device, cfg.scaled(dtype="float32", **cut),
                             batch=1, seq=seq, restart=False, pool=pool)
    free_card()
    out = {"run": run, "check": f32, "seconds": time.perf_counter() - t0}
    print(f"phase {cfg.name} training: {out['seconds']!r} s")
    return out


def int8_train_config() -> ArchConfig:
    """Phase G's model: Grok-1 at full width, ``INT8_TRAIN_LAYERS`` of its
    layers, with remat."""
    return get_arch(MOE_ARCH).scaled(n_layers=INT8_TRAIN_LAYERS, remat=True)


def moe_check_config(cfg) -> ArchConfig:
    """Phases C's and G's f32 check model: ``cfg`` at 1 layer,
    ``MOE_TRAIN_CHECK_D_FF`` and ``MOE_TRAIN_CHECK_VOCAB``, in f32."""
    return cfg.scaled(n_layers=1, d_ff=MOE_TRAIN_CHECK_D_FF,
                      vocab=MOE_TRAIN_CHECK_VOCAB, dtype="float32")


def drive_int8_training(device, kind: str, cfg, *,
                        batch: int = MOE_TRAIN_B, seq: int = MOE_TRAIN_S,
                        steps: int = TRAIN_STEPS, check_cfg=None,
                        check_batch: int = MOE_TRAIN_CHECK_B,
                        check_seq: int = INT8_CHECK_S, pool=None) -> dict:
    """Phase G: ``cfg`` (``int8_train_config()``) trained through
    ``drive_training`` on ``INT8_STATE`` moments; then, for each of
    ``INT8_CHECK_STATES``, the f32 check of phase C (``check_cfg``: 1
    layer at ``MOE_TRAIN_CHECK_D_FF`` and ``MOE_TRAIN_CHECK_VOCAB`` by
    default) on ``check_seq`` tokens with the moments held too (their CPU
    sides in ``pool`` where given); then ``check_mesh_state`` on the
    card's int8 check's state and gradients.  No kernel may launch in any
    of it."""
    t0 = time.perf_counter()
    run = drive_training(device, kind, cfg, batch=batch, seq=seq,
                         steps=steps, state_dtype=INT8_STATE)
    free_card()
    check_cfg = check_cfg or moe_check_config(cfg)
    reset_launches()
    kept = {}
    checks = {sd: check_f32_training(device, check_cfg, batch=check_batch,
                                     seq=check_seq, restart=False,
                                     state_dtype=sd,
                                     keep=kept if sd == "int8" else None,
                                     pool=pool)
              for sd in INT8_CHECK_STATES}
    free_card()
    with tempfile.TemporaryDirectory() as tmp:
        mesh = check_mesh_state(device, build_model(check_cfg, device=device),
                                kept.pop("state"), kept.pop("grads"), tmp)
    launches = launch_counts()
    out = {"run": run, "checks": checks, "mesh": mesh, "launches": launches,
           "seconds": time.perf_counter() - t0}
    print(f"phase G: {out['seconds']!r} s, launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"phase G launched kernels: {launches}")
    return out


def check_mesh_state(device, model, state: dict, grads: list,
                     directory: str) -> dict:
    """Phase G on a one-rank process group over ``device`` (NCCL on the
    card, gloo on the CPU): ``state`` (an int8 training state) saved,
    then restored with ``tree_shardings`` of ``abstract_state`` onto a
    1 x 1 ``("data", "model")`` mesh under ``fsdp_tp`` (every leaf a
    DTensor on ``device``, bit-equal to the saved one); and
    ``compressed_psum_grads`` over the group on ``grads`` (CPU tensors,
    moved to ``device``) against the CPU port's over a gloo group on the
    same gradients.  The groups are destroyed before it returns."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{directory}/pg",
                            rank=0, world_size=1)
    try:
        out = {"backend": dist.get_backend()}
        if out["backend"] != backend:
            raise AssertionError(f"process group on {out['backend']}, "
                                 f"asked for {backend}")
        opt_cfg = OptimizerConfig(state_dtype=INT8_STATE)
        CheckpointManager(directory).save(3, state)
        mesh = init_device_mesh(device.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        template = abstract_state(model, opt_cfg)
        shardings = tree_shardings(template, state_logical_axes(
            model, opt_cfg), mesh, "fsdp_tp")
        t0 = time.perf_counter()
        restored, manifest = CheckpointManager(directory).restore(
            template, shardings=shardings)
        sync(device)
        out["restore_s"] = time.perf_counter() - t0
        got, want = tree_leaves(restored), tree_leaves(state)
        out["leaves"] = len(got)
        out["restore_bit_exact"] = all(
            isinstance(a, DTensor) and a.device.type == device.type
            and a.to_local().dtype == b.dtype
            and torch.equal(a.to_local(), b) for a, b in zip(got, want))
        del restored, got
        card_g = tree_unflatten(state["params"],
                                [g.to(device) for g in grads])
        t0 = time.perf_counter()
        card, card_err = compressed_psum_grads(
            card_g, init_error_feedback(card_g))
        sync(device)
        out["compress_s"] = time.perf_counter() - t0
        cpu_g = tree_unflatten(state["params"], list(grads))
        gloo = dist.new_group(backend="gloo")
        cpu, cpu_err = compressed_psum_grads(
            cpu_g, init_error_feedback(cpu_g), group=gloo)
        out["compress_max_abs_diff"] = max(
            float((a.cpu() - b).abs().max())
            for a, b in zip(tree_leaves(card) + tree_leaves(card_err),
                            tree_leaves(cpu) + tree_leaves(cpu_err)))
    finally:
        dist.destroy_process_group()
    out["step"] = manifest["step"]
    print(f"int8 state on a 1 x 1 {backend} mesh:", json.dumps(out))
    if not (out["restore_bit_exact"] and out["step"] == 3):
        raise AssertionError(f"restore onto the mesh was not exact: {out}")
    if out["compress_max_abs_diff"] != 0.0:
        raise AssertionError(f"compressed_psum_grads on {device} differs "
                             f"from the CPU port's: {out}")
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


def dry_cell(cfg, kind: str, seq: int, batch: int, **kw) -> dict:
    """Phase H: the dry run's record of ``cfg``'s step of ``kind`` at
    (batch, seq) on a 1 x 1 mesh (a one-rank fake group; ``meta``
    tensors, nothing on the card)."""
    mesh = make_mesh((1, 1), ("data", "model"))
    try:
        return run_cell(cfg.name, kind, mesh, verbose=False, cfg=cfg,
                        shape=ShapeConfig(kind, kind, seq, batch), **kw)
    finally:
        destroy_group()


def roofline_ms(rec: dict) -> dict:
    """The three terms of ``rec`` on one H100 in ms
    (``bench_torch_roofline.time_terms``), its bound (the largest) and
    which term it is."""
    terms = {k: v * 1e3 for k, v in
             bench_torch_roofline.time_terms(rec).items()}
    dominant = max(terms, key=terms.get)
    return {**terms, "bound": terms[dominant], "dominant": dominant}


def calls_match(calls: dict, totals: dict, runs: int) -> bool:
    """Whether ``runs`` runs of the dry run's kernel ``calls`` (per run)
    make exactly the launch ``totals`` the card counted."""
    return ({k: n * runs for k, n in calls.items() if n}
            == {k: n for k, n in totals.items() if n})


def dry_records() -> dict:
    """Phase H's dry-run records (``dry_cell``) of what phases 7, 11, 14,
    C, G, I and K run on the card: each train step at its phase's config
    and sizes (not phase J's: its count walks the sLSTM's 4096 steps a
    layer in Python on ``meta`` tensors, tens of minutes), each serving
    path's prefill call and decode step at the engine's live length, and
    the 32k cells of phases 7, 11 and L-O at their depth and batch
    (decode_32k at pos 32767, its last step's).  Host work only, so
    ``main`` runs it in a process of its own beside the card's phases:
    Hymba's train step is most of it (its Mamba scan's tree of small ops;
    all the counts, the 32k cells' among them, took about 100 s at
    Hymba's 16 layers on the H100 machine's host)."""
    opt = dict(total_steps=TRAIN_STEPS, **TRAIN_OPT)
    train = {
        "phase 14": (get_arch(ARCH).scaled(remat=True), TRAIN_B, TRAIN_S,
                     "float32"),
        "phase C": (moe_train_config(), MOE_TRAIN_B, MOE_TRAIN_S,
                    "float32"),
        "phase G": (int8_train_config(), MOE_TRAIN_B, MOE_TRAIN_S,
                    INT8_STATE)}
    for phase, (arch, sizes, _) in FAMILY_TRAIN.items():
        if sizes.get("count_flops", True):
            train[f"phase {phase}"] = (family_train_config(arch),
                                       sizes.get("batch", TRAIN_B),
                                       sizes.get("seq", TRAIN_S), "float32")
    recs = {f"{name} train step": dry_cell(
        cfg, "train", seq, b, microbatches=1,
        opt_cfg=OptimizerConfig(state_dtype=sd, **opt))
        for name, (cfg, b, seq, sd) in train.items()}
    served = {
        "phase 7": (get_arch(ARCH), PREFILL_B, PREFILL_S, SLOTS, MAX_SEQ,
                    DECODE_LIVE[SLOTS, 8, 4, MAX_SEQ, 128]),
        "phase 11": (get_arch(MOE_ARCH).scaled(n_layers=MOE_LAYERS),
                     MOE_SERVE["prefill_b"], MOE_SERVE["prefill_s"],
                     MOE_SERVE["slots"], MOE_SERVE["max_seq"],
                     DECODE_LIVE[8, 8, 6, 1024, 128])}
    for name, (cfg, b, seq, slots, max_seq, live) in served.items():
        recs[f"{name} prefill call"] = dry_cell(cfg, "prefill", seq, b)
        recs[f"{name} engine step"] = dry_cell(cfg, "decode", max_seq,
                                               slots, decode_pos=live - 1)
    for phase, batch in DECODE_32K_BATCH.items():
        cfg = serving_config(phase)
        recs[f"phase {phase} prefill_32k call"] = dry_cell(
            cfg, "prefill", SEQ_32K, 1)
        recs[f"phase {phase} decode_32k step"] = dry_cell(
            cfg, "decode", SEQ_32K, batch, decode_pos=SEQ_32K - 1)
    return recs


def dry_family_cells() -> dict:
    """Phase H's dry-run records (``dry_cell``) of the cells of phases
    13, D, E and F, at the depth and batch the card runs them
    (``cell_sizes``): prefill_32k at one row (not xLSTM's:
    ``DRY_NOT_COUNTED``), decode_32k at pos 32767 and long_500k at pos
    524,287, each its last step's.  Host work only, run in the counts'
    process after ``dry_records``; Hymba's prefill_32k count walks its
    Mamba scan's 128 chunks a layer on ``meta`` tensors."""
    recs = {}
    for phase in FAMILY_CELL_BATCH:
        cfg, sizes = serving_config(phase), cell_sizes(phase)
        name = f"phase {phase} prefill_32k call"
        if name not in DRY_NOT_COUNTED:
            recs[name] = dry_cell(cfg.scaled(n_layers=sizes.get(
                "prefill_layers", cfg.n_layers)), "prefill", SEQ_32K, 1)
        recs[f"phase {phase} decode_32k step"] = dry_cell(
            cfg, "decode", SEQ_32K, sizes["decode_batch"],
            decode_pos=SEQ_32K - 1)
        if "long_seq" in sizes:
            recs[f"phase {phase} long_500k step"] = dry_cell(
                cfg, "decode", sizes["long_seq"], 1,
                decode_pos=sizes["long_seq"] - 1)
    return recs


def check_dryrun(serve: dict, moe: dict, train: dict, moe_train: dict,
                 int8_train: dict, family_train: dict, recs: dict,
                 cells: dict = None) -> dict:
    """Phase H: the dry run's records (``dry_records``) held against what
    the earlier phases measured on the card.  (a) Phases 14, C, I and K:
    the dry run's FLOPs of the train step equal ``FlopCounterMode``'s
    count of the run's last step (``LastStepFlops``), and its predicted
    peak (argument + temp + output - alias) is within ``PEAK_TOL`` of the
    phase's ``max_memory_allocated``.  (b) Phases 7 and 11: its kernel
    calls of a prefill call and of a decode step equal the launches those
    phases counted per call and per engine step; likewise for each 32k
    cell of ``cells`` (phase -> ``drive_cells``' result), its calls per
    call or step times its runs (but those of ``DRY_NOT_COUNTED``, which
    are reported as not counted).  (c) Each step and call that phases 7,
    11, 14, C, G, I and K timed, and each 32k cell's call or step, as a
    share of its roofline bound on the H100 (the largest of the compute,
    memory and collective terms).  Phase J has no record
    (``dry_records``): it is reported as skipped.  Prints its seconds;
    raises on a miss."""
    t0 = time.perf_counter()
    out = {}
    runs = {"phase 14": train, "phase C": moe_train["run"],
            **{f"phase {p}": f["run"] for p, f in family_train.items()}}
    timed = {}
    for phase, run in runs.items():
        name = f"{phase} train step"
        if name not in recs:
            out[name] = "not counted"
            print(f"phase H, {name}: skipped: the dry run walks its "
                  f"sLSTM's {run['seq']} steps a layer in Python on meta "
                  f"tensors, too slow for this run")
            continue
        rec = recs[name]
        timed[name] = (run["ms_per_step"], rec)
        peak = peak_bytes(rec)
        row = {"dry_flops": rec["flops_per_device"],
               "card_flops": run["step_flops"],
               "predicted_peak_GB": peak / 1e9,
               "card_peak_GB": run["peak_GB"],
               "peak_ratio": peak / 1e9 / run["peak_GB"]}
        out[name] = row
        print(f"phase H, {name}:", json.dumps(row))
        if int(rec["flops_per_device"]) != run["step_flops"]:
            raise AssertionError(f"{name}: the dry run counts "
                                 f"{rec['flops_per_device']} flops, the "
                                 f"card's step {run['step_flops']}")
        if not abs(row["peak_ratio"] - 1) <= PEAK_TOL:
            raise AssertionError(f"{name}: predicted peak "
                                 f"{row['predicted_peak_GB']} GB against "
                                 f"{run['peak_GB']} GB on the card")
    for name, run in (("phase 7", serve), ("phase 11", moe)):
        prefill = recs[f"{name} prefill call"]
        step = recs[f"{name} engine step"]
        in_steps = {k: v - run["after_prefill"][k]
                    for k, v in run["launches"].items()}
        row = {"prefill_calls": prefill["kernel_calls"],
               "prefill_launches": run["after_prefill"],
               "prefill_runs": run["prefill_calls"],
               "step_calls": step["kernel_calls"],
               "step_launches": in_steps,
               "engine_steps": run["engine_steps"]}
        out[name] = row
        print(f"phase H, {name} kernel calls:", json.dumps(row))
        if not (calls_match(prefill["kernel_calls"], run["after_prefill"],
                            run["prefill_calls"])
                and calls_match(step["kernel_calls"], in_steps,
                                run["engine_steps"])):
            raise AssertionError(f"{name}: dry-run kernel calls differ "
                                 f"from the launches: {row}")
        timed[f"{name} prefill call"] = (run["prefill_ms_per_call"], prefill)
        timed[f"{name} engine step"] = (run["ms_per_engine_step"], step)
    for phase, cell in (cells or {}).items():
        for shape, res in cell.items():
            what = "call" if shape.startswith("prefill") else "step"
            name = f"phase {phase} {shape} {what}"
            if name in DRY_NOT_COUNTED:
                out[name] = "not counted"
                print(f"phase H, {name}: not counted: "
                      f"{DRY_NOT_COUNTED[name]}")
                continue
            rec = recs[name]
            row = {"calls": rec["kernel_calls"], "launches": res["launches"],
                   "runs": res["runs"], "batch": res["batch"],
                   "seq": res.get("seq"), "cuts": res["cuts"],
                   "count_s": rec["lower_s"] + rec["compile_s"]}
            out[name] = row
            print(f"phase H, {name} kernel calls:", json.dumps(row))
            if not calls_match(rec["kernel_calls"], res["launches"],
                               res["runs"]):
                raise AssertionError(f"{name}: dry-run kernel calls differ "
                                     f"from the launches: {row}")
            timed[name] = (res["ms"], rec)
    timed["phase G train step"] = (int8_train["run"]["ms_per_step"],
                                   recs["phase G train step"])
    for name, (ms, rec) in timed.items():
        roof = roofline_ms(rec)
        row = {"ms": ms, **{f"{k}_ms": v for k, v in roof.items()
                            if k != "dominant"},
               "bound_by": roof["dominant"],
               "share_of_bound": roof["bound"] / ms}
        out[f"{name} roofline"] = row
        print(f"phase H, {name} against its roofline:", json.dumps(row))
    out["seconds"] = time.perf_counter() - t0
    out["count_s"] = sum(r["lower_s"] + r["compile_s"] for r in recs.values())
    print(f"phase H: {out['seconds']!r} s, its counts {out['count_s']!r} s "
          f"in their own process")
    return out


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


def host_only(threads: int = 1) -> None:
    """A worker process for host work (phase H's counts, the f32 checks'
    CPU sides): it hides the card from itself, before anything there
    initialises CUDA, so that it takes none of the card's memory, and runs
    ``threads`` threads."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(threads)


def f32_threads() -> tuple:
    """Threads of the two f32 workers, (the serving checks', the training
    checks'): the host's cores but one for the card's phases and one for
    phase H's counts, a third of them to the serving checks (short ones,
    each arriving with its phase) and the rest to the training checks
    (submitted at the start, most of the work)."""
    spare = max(2, (os.cpu_count() or 1) - 2)
    return max(1, spare // 3), spare - max(1, spare // 3)


def worker(threads: int) -> concurrent.futures.ProcessPoolExecutor:
    """One spawned ``host_only`` process of ``threads`` threads; a worker
    that dies fails its pending results (``BrokenProcessPool``)."""
    return concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"),
        initializer=host_only, initargs=(threads,))


def stop(pool) -> None:
    """End ``pool``'s process at once, whatever it is running."""
    for proc in list((pool._processes or {}).values()):
        proc.terminate()
    pool.shutdown(wait=True, cancel_futures=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card",
              file=sys.stderr)
        return 1
    # Before the first allocation: the caching allocator reads it once.
    # Phase G's 2 layers need it: with fixed segments its backward found
    # 13.7 GiB reserved but free in pieces and no 6 GiB block for the
    # stacked experts' gradient.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    # Phase H's counts (minutes of Python on meta tensors) run in a process
    # of their own beside the card's phases, and so do the f32 checks' CPU
    # sides; both end with the run.
    serve_threads, train_threads = f32_threads()
    pools = worker(1), worker(serve_threads), worker(train_threads)
    try:
        return run_phases([pools[0].submit(dry_records),
                           pools[0].submit(dry_family_cells)], *pools[1:])
    finally:
        for pool in pools:
            stop(pool)


def run_phases(dry: list, serve_pool, train_pool) -> int:
    """Phases 1-17 in order; ``dry`` the pending results of
    ``dry_records`` and ``dry_family_cells``, which phase H takes;
    ``serve_pool`` and ``train_pool`` the f32 workers, where the serving
    and the training f32 checks' CPU sides run (the training ones
    submitted after phase 2: ``submit_f32_training``): each is collected
    at the end of the first phase by which it is ready, and every one
    before phase H.  After each phase it prints the seconds since the
    first."""
    t_start = time.perf_counter()
    checks = []

    def track(*results) -> None:
        checks.extend(r for r in results if isinstance(r, Pending))

    def done(phase: str) -> None:
        for check in checks:
            if check.ready():
                check.collect()
        print(f"[{time.perf_counter() - t_start:.1f} s] phase {phase} done",
              flush=True)

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(nvidia_smi())                                       # phase 1
    print(f"f32 workers: {f32_threads()} threads (serving checks, "
          f"training checks) of the host's {os.cpu_count()} cores")
    for name, secs in build_kernels().items():                # phase 2
        print(f"built {name} in {secs:.1f} s")
    submit_f32_training(device, train_pool)
    done("2")
    checks_crop = check_kernel(device)                        # phase 3
    run = drive_main_path(device)                             # phase 4
    check_main_path(run)
    timing = time_kernel(device, kind)                        # phase 5
    drive_arena_bench(device)                                 # phase A
    done("A")
    attn_err = check_attention(device)                        # phase 6
    for cases in ((), (FLASH_32K_FAMILY_CASES, DECODE_32K_FAMILY_CASES)):
        for name, err in check_attention_32k(device, *cases).items():
            attn_err[name] = max(attn_err[name], err)
    done("6")
    cfg = get_arch(ARCH)
    served = {}
    served["7"] = drive_family(device, cfg, {},               # phases 7, 8
                               dict(n_layers=CHECK_LAYERS),
                               cells=cell_sizes("7"), pool=serve_pool)
    done("8")
    attn_time = time_attention(device, kind)                  # phase 9
    free_card()
    gmm_err = check_gmm(device)                               # phase 10
    free_card()
    done("10")
    served["11"] = drive_family(                              # 11, 12
        device, serving_config("11"), MOE_SERVE,
        dict(n_layers=CHECK_LAYERS, d_ff=MOE_CHECK_D_FF),
        cells=cell_sizes("11"), pool=serve_pool)
    done("12")
    served["13"] = drive_family(                              # phase 13
        device, serving_config("13"), KIMI_SERVE,
        dict(d_ff=KIMI_CHECK_D_FF), cells=cell_sizes("13"),
        pool=serve_pool)
    done("13")
    for phase, (_, serve_kw, check_kw) in FAMILY_PHASES.items():  # D-F
        served[phase] = drive_family(device, serving_config(phase),
                                     serve_kw, check_kw,
                                     cells=cell_sizes(phase),
                                     pool=serve_pool)
        done(phase)
    for phase, (_, _, check_kw) in CONFIG_PHASES.items():    # L-O
        served_cfg = serving_config(phase)
        print(f"phase {phase}: {served_cfg.name} at {served_cfg.n_layers} "
              f"of {get_arch(served_cfg.name).n_layers} layers, decode_32k "
              f"at a batch of {DECODE_32K_BATCH[phase]}")
        served[phase] = drive_family(device, served_cfg, KIMI_SERVE,
                                     check_kw, cells=cell_sizes(phase),
                                     pool=serve_pool)
        done(phase)
    track(*(s["f32"] for s in served.values()))
    cells = {p: s["run"]["cells"] for p, s in served.items()}
    train = drive_training(device, kind,                      # phase 14
                           cfg.scaled(remat=True))
    free_card()
    track(check_f32_training(device, cfg.scaled(              # phase 15
        n_layers=CHECK_LAYERS, dtype="float32"), pool=train_pool))
    free_card()
    done("15")
    moe_train = drive_moe_training(device, kind, train_pool)  # phase C
    track(moe_train["check"])
    free_card()
    done("C")
    int8_train = drive_int8_training(device, kind,            # phase G
                                     int8_train_config(),
                                     pool=train_pool)
    track(*int8_train["checks"].values())
    free_card()
    done("G")
    family_train = {}
    for phase, (arch, sizes, check) in FAMILY_TRAIN.items():  # I-K
        family_train[phase] = drive_family_training(
            device, kind, family_train_config(arch), sizes, check,
            train_pool)
        track(family_train[phase]["check"])
        done(phase)
    gmm_time = time_gmm(device, kind)                         # phase 16
    drive_multihost_scale()                                   # phase B
    done("B")
    t0 = time.perf_counter()
    for check in checks:
        check.collect()
    print(f"f32 checks: all {len(checks)} collected, waited "
          f"{time.perf_counter() - t0!r} s for the last", flush=True)
    if _AHEAD:
        raise AssertionError(f"f32 checks submitted ahead and never run: "
                             f"{[cfg.name for cfg, *_ in _AHEAD]}")
    recs = {k: v for d in dry for k, v in d.result().items()}
    check_dryrun(served["7"]["run"], served["11"]["run"],     # phase H
                 train, moe_train, int8_train, family_train, recs, cells)
    done("H")
    f32 = timing["f32"]
    rows = {"crop_mirror_normalize": {
        "launches": run["launches"],
        "max_abs_err": checks_crop["main_f32_max_abs_err"], "ms": f32["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": None}}
    # Launches on the serving paths and the 32k cells, each counted from 0
    # over its own run.
    runs = [s["run"] for s in served.values()] \
        + [res for cell in cells.values() for res in cell.values()]
    for name, key in (("flash_attention", "flash_attention torch.bfloat16"),
                      ("flash_decode", "flash_decode")):
        t = attn_time[key]
        rows[name] = {"launches": sum(r["launches"][name] for r in runs),
                      "max_abs_err": attn_err[name], "ms": t["ms"],
                      "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                      "bound_by": t["bound_by"],
                      "library_ms": t["library_ms"]}
    t = gmm_time["decode"]
    rows["grouped_matmul"] = {
        "launches": sum(r["launches"]["grouped_matmul"] for r in runs),
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
