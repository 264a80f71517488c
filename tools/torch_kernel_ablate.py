"""Ablations of the port's kernels on the card: each variant is the source
with one part taken out (or the wrapper with one choice changed), built
beside the real one and timed at a path shape, so that the difference says
what that part costs.  The variants' outputs are wrong by design; only
their times count.

    python3 tools/torch_kernel_ablate.py [--dry] [--only GROUP ...] [--passes N]
    python3 tools/torch_kernel_ablate.py --sync-decode DIR [--dry]
    python3 tools/torch_kernel_ablate.py --old DIR [--only f32 fdec] [--passes N]

Grouped matmul, prefill ("gmm": ``csrc/grouped_matmul_tc.cu``'s
``gmm_tma_kernel``, at Grok-1's (8, 320, 6144, 32768) and (8, 160, 6144,
32768)): ``release_cluster`` releases ring slots as the first design did,
one thread arriving at each CTA of the cluster with ``.release.cluster``
ordering; ``no_load`` issues no TMA copy (the producer arrives instead, so
the barriers still turn); ``no_mma`` issues no wgmma.

Grouped matmul, small C ("stream": ``gmm_stream_kernel``, at Grok-1's
decode (8, 8, 6144, 32768) and its down projection (8, 8, 32768, 6144),
whose last items are cut and folded, Kimi-K2's decode down projection
(384, 8, 2048, 7168), its 28-row prefill chunk (384, 28, 7168, 2048) and
the 56-row chunk off the path (384, 56, 7168, 2048)): ``no_mma`` issues
no wgmma; ``no_load`` issues no TMA copy (the producer arrives instead);
``no_x`` copies w but not x; ``stages4`` and ``stages_max`` give the ring
4 slots, and as many as shared memory holds, instead of 3; ``bn128``
takes items of 128 columns instead of 256; ``ctas132`` launches one CTA
an SM where 128 would fill whole rounds (the last items are then cut and
folded by the second pass); ``two_per_sm`` runs two CTAs an SM;
``no_fold`` skips the second pass; ``no_pdl`` launches it plainly behind
the first; ``evict_first`` loads w with an L2 evict-first policy;
``w_rows8`` and ``w_rows16`` load each slice of w as boxes of 8 or 16
rows, every panel of a row block in turn, so that one row's 512 bytes
are asked for together.
``--sync-decode DIR`` ablates, at the same shapes, the design the stream
replaced (mma.sync from a cp.async ring, one CTA per tile) in a tree that
holds it (e.g. the commit before the stream, unpacked with ``git
archive``), with that tree's wrapper: ``no_mma`` (no ldmatrix or
mma.sync: the load scheme's own ceiling), ``no_load``, ``stages5`` and
``stages8`` (a deeper ring, at two and one CTAs an SM), ``bn256`` (256
columns, 3 stages, two CTAs an SM).

Flash attention (``csrc/flash_attention_wgmma.cu``, at Qwen3-4B's
(4, 32, 8, 2048, 128) and a D = 64 shape, (4, 25, 5, 2048, 64), causal and
not): ``no_softmax`` skips the max, the exponentials and the rescale;
``no_kv_load`` issues no copy of K or V (the producer arrives instead);
``pingpong_flip`` flips the choice of which head dims the consumer
warpgroups take turns at (the kernel: at D > 64 only); ``stages3``
deepens the K/V ring to 3 slots; ``one_cta_per_item`` launches the same
kernel with a CTA per work item instead of a persistent CTA per SM.

Grouped matmul, f32 ("f32": ``csrc/grouped_matmul.cu`` at Grok-1's
(8, 320, 6144, 32768) and its down projection, TF32 off): ``no_mma``
adds each loaded value once instead of the products (the shared-memory
reads stay); ``no_load`` loads nothing from device memory; ``x_store_vec``
stores x's slice as 16-byte rows instead of transposed floats;
``tm4tn8`` and ``tm8tn16`` take a 4 x 8 or 8 x 16 thread tile at 64 rows
instead of 8 x 8.

Flash decode, bf16 ("fdec": ``csrc/flash_decode_tc.cu`` at decode_32k
(16, 8, 4, 32768, 128), events and CUDA graph, and the dense serving cache
(8, 8, 4, 4096, 128) at 4096 and 160 keys, from a graph): ``no_mma`` keeps
ldmatrix and drops mma.sync; ``no_load`` issues no copy; ``stages2`` and
``stages4`` give the cp.async ring 2 or 4 slots (4 hold one CTA an SM, so
one CTA a row); ``split1`` takes one CTA a row with 3 slots; ``prefetch2``
asks L2 for the K rows two tiles ahead, ``no_prefetch`` for none;
``l2_128`` asks L2 for 128 bytes a copy instead of 256; ``evict_first``
marks K and V evict-first in L2.

Flash attention, f32 ("fa32": ``csrc/flash_attention.cu`` at Qwen3-4B's
(4, 32, 8, 2048, 2048, 128) causal and a full-width D = 64 shape, (4, 25,
5, 2048, 2048, 64) causal with a 1024-key window, beside SDPA in f32 with
the same mask): ``no_mma`` adds each value read from shared memory once
instead of the products of S = Q K^T and O += P V (the reads stay);
``no_load`` issues no copy of K or V (the ring's waits and barriers
stay); ``no_exp`` takes the exponentials out of the softmax;
``qk_copies`` unrolls the loop over K's panels (a copy of the S loop
each), ``qk_unroll_all`` also the S loop within a panel; ``pv_unroll4``
unrolls P V 4 times instead of 2; ``bq64`` takes 64-row blocks (a 4 x 8
thread tile) where the plan takes 128; ``bk64`` takes 64-key tiles (an
8 x 4 score tile a thread).

``--old DIR`` runs the f32 group's ``base``, ``no_mma``, ``no_load`` and
``x_store_vec``, the decode group and the fa32 group's ``base``,
``no_mma`` and ``no_load`` (edits of the 64-row, 32-key kernel that the
128-row design replaced) on tree DIR's sources and wrappers (e.g. the
parent commit unpacked with ``git archive``), and writes
``kernel_ablation_old.json``; with ``--dry`` it checks that those edits
apply to DIR's sources.

Each grouped-matmul group also times ``torch.bmm`` at its shapes (the f32
group with TF32 off), the decode group SDPA from a graph, the fa32 group
SDPA in f32.  Prints
the card's name and power limit and one JSON object of device ms per
launch (CUDA events, median), and writes it to
``chiprun_out/kernel_ablation.json`` (``kernel_ablation_sync_decode.json``
with ``--sync-decode``).  ``--dry`` only checks, without a card, that
every variant's edits apply to the sources.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from repro_torch.kernels import build  # noqa: E402

GMM = "grouped_matmul_tc.cu"
FLASH = "flash_attention_wgmma.cu"
F32 = "grouped_matmul.cu"
FDEC = "flash_decode_tc.cu"
# Flash decode, bf16 (csrc/flash_decode_tc.cu, at decode_32k and the dense
# serving cache): mma.sync out, copies out, the cp.async ring's depth, one
# CTA a row, and no L2 prefetch of the next tile's K rows.
FDEC_VARIANTS = {
    "fdec base": (FDEC, [], {}),
    # ldmatrix kept, mma.sync taken out
    "fdec no_mma": (FDEC, [
        ("      mma_bf16_16816(s[0], a, kf);\n"
         "      mma_bf16_16816(s[1], a, kf + 2);\n",
         "      s[0][0] += __uint_as_float((kf[0] ^ kf[1] ^ kf[2] ^ kf[3] ^ a[0])\n"
         "                                 & 0x3f800000u);\n"),
        ("      mma_bf16_16816(acc[j], pf, vf);\n"
         "      mma_bf16_16816(acc[j + 1], pf, vf + 2);\n",
         "      acc[j][0] += __uint_as_float((vf[0] ^ vf[1] ^ pf[0]) & 0x3f800000u);\n"
         "      acc[j + 1][0] += __uint_as_float((vf[2] ^ vf[3] ^ pf[2])\n"
         "                                       & 0x3f800000u);\n")], {}),
    "fdec no_load": (FDEC, [
        ("    cp_async16_l2_256(\n"
         "        dst + r * (D + 8) + col,\n"
         "        ok ? src + static_cast<long long>(t0 + r) * stride + col : src,\n"
         "        ok ? 16 : 0);\n", "    (void)ok; (void)col;\n"),
        ("      if (nt + 1 < n_tiles && tp < t_end && (threadIdx.x % 2 == 0 || D > 64))\n"
         "        prefetch_l2(kp + tp * skt + (threadIdx.x % 2) * 64);\n",
         "      (void)tp;\n")], {}),
    "fdec stages2": (FDEC, [("constexpr int kStages = 3;",
                             "constexpr int kStages = 2;")], {"TC_STAGES": 2}),
    # 4 slots (139 KB at D = 128) hold one CTA an SM: one CTA a row
    "fdec stages4": (FDEC, [("constexpr int kStages = 3;",
                             "constexpr int kStages = 4;")],
                     {"TC_STAGES": 4, "TC_CTAS_PER_SM": 1}),
    # 3 slots, one CTA a row (128 at decode_32k): the split's share
    "fdec split1": (FDEC, [], {"TC_CTAS_PER_SM": 1}),
    # L2 asked for the K rows two tiles past the newest in flight
    "fdec prefetch2": (FDEC, [(
        "      const int tp = (tile_lo + nt + 1) * kTile + threadIdx.x / 2;\n"
        "      if (nt + 1 < n_tiles",
        "      const int tp = (tile_lo + nt + 2) * kTile + threadIdx.x / 2;\n"
        "      if (nt + 2 < n_tiles")], {}),
    # the copies ask L2 for 128 bytes instead of 256, or mark K and V
    # evict-first in L2
    "fdec l2_128": (FDEC, [(
        "    cp_async16_l2_256(\n",
        "    asm volatile(\"cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\\n\"\n"
        "                 :: \"r\"(smem_addr(dst + r * (D + 8) + col)),\n"
        "                 \"l\"(ok ? src + static_cast<long long>(t0 + r) * stride + col : src),\n"
        "                 \"r\"(ok ? 16 : 0) : \"memory\");\n"
        "    if (false) cp_async16_l2_256(\n")], {}),
    "fdec evict_first": (FDEC, [(
        "    cp_async16_l2_256(\n",
        "    uint64_t pol;\n"
        "    asm volatile(\"createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\" : \"=l\"(pol));\n"
        "    asm volatile(\"cp.async.cg.shared.global.L2::cache_hint.L2::256B [%0], [%1], 16, %2, %3;\\n\"\n"
        "                 :: \"r\"(smem_addr(dst + r * (D + 8) + col)),\n"
        "                 \"l\"(ok ? src + static_cast<long long>(t0 + r) * stride + col : src),\n"
        "                 \"r\"(ok ? 16 : 0), \"l\"(pol) : \"memory\");\n"
        "    if (false) cp_async16_l2_256(\n")], {}),
    "fdec no_prefetch": (FDEC, [(
        "      if (nt + 1 < n_tiles && tp < t_end && (threadIdx.x % 2 == 0 || D > 64))\n"
        "        prefetch_l2(kp + tp * skt + (threadIdx.x % 2) * 64);\n",
        "      (void)tp;\n")], {}),
}
# The f32 grouped matmul (csrc/grouped_matmul.cu, at Grok-1's prefill chunk
# and its down projection), here and in a tree before its 8 x 8 tile
# (--old DIR, e.g. the parent commit unpacked with git archive, with that
# tree's wrappers): products out (each loaded value added once, so the
# shared-memory reads stay), loads out, and x's slice stored as 16-byte
# rows in load order instead of transposed floats (a wrong layout: only
# the time counts).
F32_COMMON = {
    "f32 base": (F32, [], {}),
    # no products: each loaded value is added once, so the shared-memory
    # reads stay
    "f32 no_mma": (F32, [(
        "#pragma unroll\n"
        "      for (int i = 0; i < TM; ++i)\n"
        "#pragma unroll\n"
        "        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);\n",
        "#pragma unroll\n"
        "      for (int i = 0; i < TM; ++i) acc[i][0] += a[i];\n"
        "#pragma unroll\n"
        "      for (int j = 0; j < TN; ++j) acc[0][j] += b[j];\n")], {}),
    "f32 no_load": (F32, [
        ("        load_chunk<T, VEC>(xe + (m0 + r) * sxc, k0 + kc, d, m0 + r < C,\n"
         "                           a_reg[i]);\n",
         "        for (int j = 0; j < V; ++j) a_reg[i][j] = 1.f + r + kc;\n"),
        ("      load_chunk<T, VEC>(we + (k0 + r) * swd, n0 + nc, f, k0 + r < d,\n"
         "                         b_reg[i]);\n",
         "      for (int j = 0; j < V; ++j) b_reg[i][j] = 1.f + r + nc;\n")], {}),
    # x's slice stored as 16-byte rows in load order instead of transposed
    # one float at a time (a wrong layout: only the time counts)
    "f32 x_store_vec": (F32, [(
        "#pragma unroll\n"
        "        for (int j = 0; j < V; ++j) As[buf][kc + j][r] = a_reg[i][j];\n",
        "        (void)r; (void)kc;\n"
        "        *reinterpret_cast<float4*>(&As[buf][0][0] + c * V) = make_float4(\n"
        "            a_reg[i][0], a_reg[i][1], a_reg[i][2], a_reg[i][3]);\n")], {}),
}
# Here also the first design's 4 x 8 thread tile at 64 rows, and 8 x 16.
F32_VARIANTS = {
    **F32_COMMON,
    "f32 tm4tn8": (F32, [(
        "      return launch<T, 64, 8, 8, VEC>(x, w, o, E, C, d, f, st, stream);",
        "      return launch<T, 64, 4, 8, VEC>(x, w, o, E, C, d, f, st, stream);")],
        {"F32_THREAD_TILES": ((8, 1), (4, 4), (4, 8))}),
    "f32 tm8tn16": (F32, [(
        "      return launch<T, 64, 8, 8, VEC>(x, w, o, E, C, d, f, st, stream);",
        "      return launch<T, 64, 8, 16, VEC>(x, w, o, E, C, d, f, st, stream);")],
        {"F32_THREAD_TILES": ((8, 1), (4, 4), (8, 16))}),
}
FA32 = "flash_attention.cu"
# The f32 flash attention as it was before its 128-row redesign (64-row
# blocks, 32-key tiles loaded to registers and stored between two
# barriers, a 4 x 2 score tile a thread), for --old DIR: products out
# (each value read from shared memory added once) and K/V loads out.
FA32_OLD_VARIANTS = {
    "fa32 base": (FA32, [], {}),
    "fa32 no_mma": (FA32, [
        ("#pragma unroll\n"
         "      for (int i = 0; i < kRows; ++i)\n"
         "#pragma unroll\n"
         "        for (int j = 0; j < kCols; ++j) {\n"
         "          float t = s[i][j];\n"
         "          t = fmaf(qv[i].x, kv[j].x, t);\n"
         "          t = fmaf(qv[i].y, kv[j].y, t);\n"
         "          t = fmaf(qv[i].z, kv[j].z, t);\n"
         "          t = fmaf(qv[i].w, kv[j].w, t);\n"
         "          s[i][j] = t;\n"
         "        }\n",
         "#pragma unroll\n"
         "      for (int i = 0; i < kRows; ++i) {\n"
         "        s[i][0] += qv[i].x + qv[i].w;\n"
         "        s[i][1] += qv[i].y + qv[i].z;\n"
         "      }\n"
         "#pragma unroll\n"
         "      for (int j = 0; j < kCols; ++j) {\n"
         "        s[0][j] += kv[j].x + kv[j].y;\n"
         "        s[1][j] += kv[j].z + kv[j].w;\n"
         "      }\n"),
        ("#pragma unroll\n"
         "          for (int c = 0; c < kNC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);\n"
         "        }\n",
         "          acc[i][0] += p;\n"
         "        }\n"
         "#pragma unroll\n"
         "        for (int c = 0; c < kNC; ++c) acc[0][c] += vv[c];\n")], {}),
    "fa32 no_load": (FA32, [(
        "    load_tile<T, D>(kp, sks, k0, T_len, kBK, Ks, kLdQK);\n"
        "    load_tile<T, D>(vp, svs, k0, T_len, kBK, Vs, D);\n",
        "    (void)kp; (void)vp;\n")], {}),
}
OLD_VARIANTS = {**F32_COMMON, **FDEC_VARIANTS, **FA32_OLD_VARIANTS}
# The f32 flash attention (csrc/flash_attention.cu): products out (each
# value read from shared memory added once), K/V copies out, exponentials
# out, the loops' copies and unrolling, 64-row blocks (a 4 x 8 thread
# tile) and 64-key tiles (8 x 4 scores a thread).
FA32_VARIANTS = {
    "fa32 base": (FA32, [], {}),
    "fa32 no_mma": (FA32, [
        ("#pragma unroll\n"
         "        for (int j = 0; j < kKeys; ++j) {\n"
         "          float t = s[i][j];\n"
         "          t = fmaf(qv.x, kv[j].x, t);\n"
         "          t = fmaf(qv.y, kv[j].y, t);\n"
         "          t = fmaf(qv.z, kv[j].z, t);\n"
         "          t = fmaf(qv.w, kv[j].w, t);\n"
         "          s[i][j] = t;\n"
         "        }\n",
         "        s[i][0] += qv.x + qv.w;\n"
         "        s[i][1] += qv.y + qv.z;\n"
         "#pragma unroll\n"
         "        for (int j = 0; j < kKeys; ++j)\n"
         "          if (i == 0) {\n"
         "            s[0][j] += kv[j].x + kv[j].y;\n"
         "            s[1][j] += kv[j].z + kv[j].w;\n"
         "          }\n"),
        ("#pragma unroll\n"
         "      for (int i = 0; i < TM; ++i) {\n"
         "        const float p = lane(pv[i], u);\n"
         "#pragma unroll\n"
         "        for (int c = 0; c < NP * VW; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);\n"
         "      }\n",
         "#pragma unroll\n"
         "      for (int i = 0; i < TM; ++i) acc[i][0] += lane(pv[i], u);\n"
         "#pragma unroll\n"
         "      for (int c = 0; c < NP * VW; ++c) acc[0][c] += vv[c];\n")],
        {}),
    "fa32 no_load": (FA32, [(
        "      cp_async16(dst + e * kStep * W, ok ? src + e * stride : kp,\n"
        "                 ok ? 16 : 0);\n",
        "      (void)dst; (void)ok; (void)src; (void)stride;\n")], {}),
    # the exponentials taken out (the softmax's other arithmetic stays)
    "fa32 no_exp": (FA32, [
        ("      const float corr = exp2f(m[i] - m_new);",
         "      const float corr = m[i] - m_new;"),
        ("        s[i][j] = exp2f(s[i][j] - m_new);",
         "        s[i][j] = s[i][j] - m_new;")], {}),
    # K's panels unrolled (a copy of the S loop each), the S loop unrolled
    # whole within a panel, P V 4 times instead of 2
    "fa32 qk_copies": (FA32, [("#pragma unroll 1\n    for (int p = 0;",
                               "#pragma unroll\n    for (int p = 0;")], {}),
    "fa32 qk_unroll_all": (FA32, [
        ("#pragma unroll 1\n    for (int p = 0;",
         "#pragma unroll\n    for (int p = 0;"),
        ("#pragma unroll 1\n  for (int c4 = 0;",
         "#pragma unroll\n  for (int c4 = 0;")], {}),
    "fa32 pv_unroll4": (FA32, [("#pragma unroll 2\n  for (int kk = 0;",
                                "#pragma unroll 4\n  for (int kk = 0;")], {}),
    "fa32 bq64": (FA32, [], {"F32_BLOCKS": (64,)}),
    "fa32 bk64": (FA32, [("constexpr int kBK = 128;", "constexpr int kBK = 64;")],
                  {"F32_BLOCK_K": 64}),
}
# variant -> (source, [(text, replacement), ...], {wrapper attribute: value})
VARIANTS = {
    "gmm base": (GMM, [], {}),
    "gmm release_cluster": (GMM, [(
        "    if (tid < CS) mbar_arrive_cluster(empty + s, tid);",
        "    if (tid == 0)\n      for (int r = 0; r < CS; ++r)\n"
        "        asm volatile(\"{\\n.reg .b32 rem;\\n"
        "mapa.shared::cluster.u32 rem, %0, %1;\\n"
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [rem];\\n"
        "}\\n\" :: \"r\"(smem_addr(empty + s)), \"r\"(r) : \"memory\");")], {}),
    "gmm no_load": (GMM, [
        ("        tma_load_3d(st, &wmap, full + s, f0, kt * BK, e);\n"
         "        tma_load_3d(st + TT::kWBytes / 2, &wmap, full + s, f0 + 64,"
         " kt * BK,\n                    e);\n", ""),
        ("        tma_load_3d_multicast(st + TT::kWBytes + rank * TT::kXPart"
         " * 128,\n                              &xmap, full + s,\n"
         "                              static_cast<uint16_t>((1 << CS) - 1),"
         " kt * BK,\n                              t0 + rank * TT::kXPart, e);"
         "\n", ""),
        ("mbar_expect_tx(full + s, TT::kStageBytes);",
         "mbar_arrive(full + s);")], {}),
    "gmm no_mma": (GMM, [("        wgmma_m64n160k16_ta(acc[h], da, db);",
                          "        (void)da;\n        (void)db;")], {}),
    "stream base": (GMM, [], {}),
    "stream no_mma": (GMM, [(
        "          wgmma_m64nNk16_ta<N>(\n"
        "              acc[p], smem_desc(st + p * 8192 + ks * 2048, 1024, 1024),"
        " db);\n", "          (void)db;\n")], {}),
    "stream no_load": (GMM, [
        ("          mbar_expect_tx(full + slot, ST::kSlot);\n"
         "#pragma unroll\n"
         "          for (int p = 0; p < NT; ++p)\n"
         "            tma_load_3d(st + p * 8192, &wmap, full + slot, f0 + 64 * p,\n"
         "                        64 * s, e);\n"
         "          tma_load_3d(st + ST::kWBytes, &xmap, full + slot, 64 * s, 0, e);\n",
         "          mbar_arrive(full + slot);\n          (void)st;\n"
         "          (void)f0;\n")], {}),
    "stream no_x": (GMM, [
        ("          mbar_expect_tx(full + slot, ST::kSlot);\n",
         "          mbar_expect_tx(full + slot, ST::kWBytes);\n"),
        ("          tma_load_3d(st + ST::kWBytes, &xmap, full + slot, 64 * s, 0, e);\n",
         "")], {}),
    "stream w_rows8": (GMM, [
        ("#pragma unroll\n"
         "          for (int p = 0; p < NT; ++p)\n"
         "            tma_load_3d(st + p * 8192, &wmap, full + slot, f0 + 64 * p,\n"
         "                        64 * s, e);\n",
         "          for (int rb = 0; rb < 64 / 8; ++rb)\n"
         "            for (int p = 0; p < NT; ++p)\n"
         "              tma_load_3d(st + p * 8192 + rb * 8 * 128, &wmap,\n"
         "                          full + slot, f0 + 64 * p, 64 * s + 8 * rb, e);\n"),
        ("  if (err == 0) err = encode_bf16_map(&wm, w, 3, wl);\n"
         "  if (err != 0) return err;\n  auto kernel = gmm_stream_kernel<N, NT>;",
         "  long long wl_rows[kMapWords];\n"
         "  for (int i = 0; i < kMapWords; ++i) wl_rows[i] = wl[i];\n"
         "  wl_rows[6] = 8;\n"
         "  if (err == 0) err = encode_bf16_map(&wm, w, 3, wl_rows);\n"
         "  if (err != 0) return err;\n  auto kernel = gmm_stream_kernel<N, NT>;")],
        {}),
    "stream w_rows16": (GMM, [
        ("#pragma unroll\n"
         "          for (int p = 0; p < NT; ++p)\n"
         "            tma_load_3d(st + p * 8192, &wmap, full + slot, f0 + 64 * p,\n"
         "                        64 * s, e);\n",
         "          for (int rb = 0; rb < 64 / 16; ++rb)\n"
         "            for (int p = 0; p < NT; ++p)\n"
         "              tma_load_3d(st + p * 8192 + rb * 16 * 128, &wmap,\n"
         "                          full + slot, f0 + 64 * p, 64 * s + 16 * rb, e);\n"),
        ("  if (err == 0) err = encode_bf16_map(&wm, w, 3, wl);\n"
         "  if (err != 0) return err;\n  auto kernel = gmm_stream_kernel<N, NT>;",
         "  long long wl_rows[kMapWords];\n"
         "  for (int i = 0; i < kMapWords; ++i) wl_rows[i] = wl[i];\n"
         "  wl_rows[6] = 16;\n"
         "  if (err == 0) err = encode_bf16_map(&wm, w, 3, wl_rows);\n"
         "  if (err != 0) return err;\n  auto kernel = gmm_stream_kernel<N, NT>;")],
        {}),
    "stream stages4": (GMM, [], {"STREAM_STAGES": 4}),
    # as many slots as shared memory holds: 6 at 8 rows, 5 at 32, 4 at 64
    "stream stages_max": (GMM, [], {"STREAM_STAGES": 2 ** 30}),
    # two CTAs an SM, each with a 3-slot ring
    "stream two_per_sm": (GMM, [], {
        "stream_ctas": lambda items, slices: min(264, items * slices)}),
    "stream no_pdl": (GMM, [(
        "  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
        "  attr[0].val.programmaticStreamSerializationAllowed = 1;\n"
        "  cfg.attrs = attr;\n  cfg.numAttrs = 1;\n",
        "  (void)attr;\n")], {}),
    "stream bn128": (GMM, [("  if (bn == 256)\n    return dispatch_stream<4>(",
                            "  if (bn == 128)\n    return dispatch_stream<2>(")],
                     {"STREAM_BN": 128}),
    # one CTA an SM even where fewer would fill whole rounds: the items
    # left after the rounds are cut and folded by the second pass
    "stream ctas132": (GMM, [], {
        "stream_ctas": lambda items, slices: min(132, items * slices)}),
    "stream no_fold": (GMM, [(
        "  if (e != cudaSuccess || part == nullptr) return static_cast<int>(e);",
        "  return static_cast<int>(e);")], {}),
    "stream evict_first": (GMM, [(
        "            tma_load_3d(st + p * 8192, &wmap, full + slot, f0 + 64 * p,\n"
        "                        64 * s, e);\n",
        "            asm volatile(\"{\\n.reg .b64 pol;\\n"
        "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\\n"
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5}],"
        " [%2], pol;\\n}\\n\" :: \"r\"(smem_addr(st + p * 8192)), "
        "\"l\"(reinterpret_cast<uint64_t>(&wmap)), \"r\"(smem_addr(full + slot)), "
        "\"r\"(f0 + 64 * p), \"r\"(64 * s), \"r\"(e) : \"memory\");\n")], {}),
    "flash base": (FLASH, [], {}),
    "flash no_softmax": (FLASH, [
        ("      softmax(k_lo, corr);", "      corr[0] = corr[1] = 1.f;"),
        ("        softmax(k_lo + t * kBKV, corr);",
         "        corr[0] = corr[1] = 1.f;")], {}),
    "flash no_kv_load": (FLASH, [
        ("          mbar_expect_tx(k_full + s, L::kTileBytes);\n"
         "#pragma unroll\n"
         "          for (int p = 0; p < L::kPanels; ++p)\n"
         "            tma_load_4d(kt + p * kBKV * 128, &kmap, k_full + s, 64 * p,"
         " k0,\n                        kvh, b);\n",
         "          mbar_arrive(k_full + s);\n"),
        ("          mbar_expect_tx(v_full + s, L::kTileBytes);\n"
         "#pragma unroll\n"
         "          for (int p = 0; p < L::kPanels; ++p)\n"
         "            tma_load_4d(vt + p * kBKV * 128, &vmap, v_full + s, 64 * p,"
         " k0,\n                        kvh, b);\n",
         "          mbar_arrive(v_full + s);\n")], {}),
    "flash pingpong_flip": (FLASH, [
        ("constexpr bool kPingPong = DP > 64;",
         "constexpr bool kPingPong = DP <= 64;")], {}),
    "flash stages3": (FLASH, [("constexpr int kStages = 2;",
                               "constexpr int kStages = 3;")], {}),
    # the same source, launched with one CTA per work item
    "flash one_cta_per_item": (FLASH, [], {"SMS": 2 ** 30}),
    **FDEC_VARIANTS,
    **F32_VARIANTS,
    **FA32_VARIANTS,
}
# The small-C design the stream replaced, for a tree that holds it
# (--sync-decode): its 32-row decode tile, launch<32, 128, 64, 1, 4, 4, VEC>.
SYNC_DECODE_VARIANTS = {
    "decode base": (GMM, [], {}),
    "decode no_mma": (GMM, [(
        "          mma_bf16_16816(acc[i][j], af[i], bfr);\n"
        "          mma_bf16_16816(acc[i][j + 1], af[i], bfr + 2);\n",
        "          (void)af;\n")], {}),
    "decode no_load": (GMM, [
        ("      load_chunk<VEC>(a + r * LDA + kc, xe + row * sxc + k0 + kc, x,\n"
         "                      row < C ? k_end - (k0 + kc) : 0);\n",
         "      (void)a; (void)row; (void)kc;\n"),
        ("      load_chunk<VEC>(b + r * LDB + nc, we + krow * swd + n0 + nc, w,\n"
         "                      krow < k_end ? f - (n0 + nc) : 0);\n",
         "      (void)b; (void)krow; (void)nc;\n")], {}),
    "decode stages5": (GMM, [("launch<32, 128, 64, 1, 4, 4, VEC>",
                              "launch<32, 128, 64, 1, 4, 5, VEC>")], {}),
    "decode stages8": (GMM, [("launch<32, 128, 64, 1, 4, 4, VEC>",
                              "launch<32, 128, 64, 1, 4, 8, VEC>")], {}),
    "decode bn256": (GMM, [("launch<32, 128, 64, 1, 4, 4, VEC>",
                            "launch<32, 256, 64, 1, 4, 3, VEC>")], {}),
}
GMM_SHAPES = [(8, 320, 6144, 32768), (8, 160, 6144, 32768)]
DECODE_SHAPES = [(8, 8, 6144, 32768), (8, 8, 32768, 6144), (384, 8, 2048, 7168),
                 (384, 28, 7168, 2048), (384, 56, 7168, 2048)]
FLASH_SHAPES = [(4, 32, 8, 2048, 128), (4, 25, 5, 2048, 64)]
# f32: Grok-1's prefill chunk and its down projection
F32_SHAPES = [(8, 320, 6144, 32768), (8, 320, 32768, 6144)]
# f32 flash attention ((B, H, K, S, T, D), causal, window): Qwen3-4B's
# prefill and a full-width D = 64 shape with Hymba's window
FA32_SHAPES = [((4, 32, 8, 2048, 2048, 128), True, 0),
               ((4, 25, 5, 2048, 2048, 64), True, 1024)]
# bf16 decode (B, K, G, T, D, live length): decode_32k, the dense serving
# cache whole and at its live length
FDEC_SHAPES = [(16, 8, 4, 32768, 128, 32768), (8, 8, 4, 4096, 128, 4096),
               (8, 8, 4, 4096, 128, 160)]


def variant_source(name: str, variants: dict = VARIANTS) -> str:
    """The source text of one variant; raises if an edit does not apply."""
    source, edits, _ = variants[name]
    text = (build.CSRC / source).read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"{name}: {old[:60]!r} is not in {source}")
        text = text.replace(old, new)
    return text


def build_variant(name: str, text: str) -> Path:
    out = ROOT / "build" / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    stem = name.replace(" ", "_")
    src = build.CSRC / f"_ablate_{stem}.cu"     # beside the headers
    src.write_text(text)
    lib = out / f"{stem}.so"
    try:
        subprocess.run(["/usr/local/cuda/bin/nvcc", *build.NVCC_FLAGS, "-o",
                        str(lib), str(src)], check=True)
    finally:
        src.unlink()
    return lib


def use_tree(tree: Path) -> None:
    """Import the port's modules and chip_smoke from ``tree`` instead."""
    global build
    for name in [m for m in sys.modules
                 if m.split(".")[0] in ("repro_torch", "chip_smoke")]:
        del sys.modules[name]
    sys.path[:0] = [str(tree), str(tree / "src")]
    build = importlib.import_module("repro_torch.kernels.build")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry", action="store_true")
    ap.add_argument("--only", nargs="*",
                    default=("gmm", "stream", "flash", "f32", "fdec", "fa32"),
                    help="groups of variants to run")
    ap.add_argument("--sync-decode", type=Path, metavar="DIR",
                    help="ablate the mma.sync decode design of tree DIR")
    ap.add_argument("--old", type=Path, metavar="DIR",
                    help="ablate the f32 grouped matmul, bf16 flash "
                         "decode and f32 flash attention that tree DIR "
                         "holds")
    ap.add_argument("--passes", type=int, default=1,
                    help="time the f32 and decode variants this many "
                         "times, every other pass in reverse order")
    a = ap.parse_args()
    variants, groups, out_name = VARIANTS, a.only, "kernel_ablation.json"
    if a.sync_decode:
        use_tree(a.sync_decode.resolve())
        variants, groups = SYNC_DECODE_VARIANTS, ("decode",)
        out_name = "kernel_ablation_sync_decode.json"
    if a.old:
        use_tree(a.old.resolve())
        variants, out_name = OLD_VARIANTS, "kernel_ablation_old.json"
    texts = {name: variant_source(name, variants) for name in variants}
    chosen = [n for n in variants if n.split()[0] in groups]
    if a.dry:
        print(f"{len(variants)} variants apply")
        return 0
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     grouped_matmul, ops)
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    print(chip_smoke.nvidia_smi())
    # one build per distinct source text
    first = {}
    for name in chosen:
        first.setdefault(texts[name], name)
    def try_build(name, text):
        try:
            return build_variant(name, text)
        except subprocess.CalledProcessError:
            print(f"!! {name} did not build: left out")
            return None

    with concurrent.futures.ThreadPoolExecutor(len(first)) as pool:
        built = dict(zip(first.values(), pool.map(
            try_build, first.values(), first.keys())))
    chosen = [n for n in chosen if built[first[texts[n]]] is not None]
    libs = {name: built[first[texts[name]]] for name in chosen}
    device = torch.device("cuda", 0)
    gen = torch.Generator(device).manual_seed(0)

    def randn(shape, scale=1.0, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=device).mul_(scale)

    def use(name, module, source, bind):
        """Load ``name``'s library and set its wrapper attributes; returns
        the attributes to restore."""
        lib = ctypes.CDLL(str(libs[name]))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        bind(lib)
        build._libs[source] = lib
        knobs = variants[name][2]
        saved = {k: getattr(module, k) for k in knobs}
        for k, v in knobs.items():
            setattr(module, k, v)
        if hasattr(module.plan, "cache_clear"):
            module.plan.cache_clear()
        return saved

    def restore(module, saved):
        for k, v in saved.items():
            setattr(module, k, v)
        if hasattr(module.plan, "cache_clear"):
            module.plan.cache_clear()

    out = {}
    gm = grouped_matmul
    for group, shapes in (("gmm", GMM_SHAPES), ("stream", DECODE_SHAPES),
                          ("decode", DECODE_SHAPES)):
        names = [n for n in chosen if n.split()[0] == group]
        for E, C, d, f in shapes if names else ():
            x, w = randn((E, C, d)), randn((E, d, f), d ** -0.5)
            for i in range(a.passes):
                tag = f" pass {i + 1}" if a.passes > 1 else ""
                for name in names if i % 2 == 0 else names[::-1]:
                    saved = use(name, gm, gm.TC_SOURCE, gm._bind_tc)
                    out[f"{name} {(E, C, d, f)}{tag}"] = \
                        chip_smoke.median_event_ms(
                            lambda: ops.grouped_matmul(x, w), n=5, repeats=5)
                    restore(gm, saved)
                out[f"{group} bmm {(E, C, d, f)}{tag}"] = \
                    chip_smoke.median_event_ms(lambda: torch.bmm(x, w), n=5,
                                               repeats=5)
            del x, w
    torch.backends.cuda.matmul.allow_tf32 = False
    names = [n for n in chosen if n.split()[0] == "f32"]
    for E, C, d, f in F32_SHAPES if names else ():
        x = randn((E, C, d), dtype=torch.float32)
        w = randn((E, d, f), d ** -0.5, torch.float32)
        for i in range(a.passes):
            tag = f" pass {i + 1}" if a.passes > 1 else ""
            for name in names if i % 2 == 0 else names[::-1]:
                saved = use(name, gm, gm.SOURCE, gm._bind)
                out[f"{name} {(E, C, d, f)}{tag}"] = chip_smoke.median_event_ms(
                    lambda: ops.grouped_matmul(x, w), n=1, repeats=5)
                restore(gm, saved)
            out[f"f32 bmm {(E, C, d, f)}{tag}"] = chip_smoke.median_event_ms(
                lambda: torch.bmm(x, w), n=1, repeats=5)
        del x, w
    da = decode_attention
    names = [n for n in chosen if n.split()[0] == "fdec"]
    for B, K, G, T, D, n in FDEC_SHAPES if names else ():
        q = randn((B, K, G, D))
        k, v = (randn((B, T, K, D)).transpose(1, 2) for _ in "kv")
        lengths = torch.full((B,), n, dtype=torch.int32, device=device)
        mask = (torch.arange(T, device=device)[None, :]
                < lengths[:, None])[:, None, None, :]
        q_h = q.reshape(B, K * G, 1, D)
        shape = (B, K, G, T, D)
        for i in range(a.passes):
            tag = f" pass {i + 1}" if a.passes > 1 else ""
            for name in names if i % 2 == 0 else names[::-1]:
                saved = use(name, da, da.TC_SOURCE, da._bind_tc)
                fn = lambda: ops.flash_decode(q, k, v, lengths)  # noqa: E731
                if n == T == 32768:
                    out[f"{name} {shape} len {n}{tag}"] = \
                        chip_smoke.median_event_ms(fn, n=10, repeats=10)
                out[f"{name} {shape} len {n} graph{tag}"] = \
                    chip_smoke.median_graph_ms(fn, n=20, repeats=10)
                restore(da, saved)
            out[f"fdec sdpa {shape} len {n} graph{tag}"] = \
                chip_smoke.median_graph_ms(
                    lambda: F.scaled_dot_product_attention(
                        q_h, k, v, attn_mask=mask, enable_gqa=True),
                    n=20, repeats=10)
        del q, k, v, mask
    fa = flash_attention
    names = [n for n in chosen if n.split()[0] == "fa32"]
    for (B, H, K, S, T, D), causal, window in FA32_SHAPES if names else ():
        q = randn((B, S, H, D), dtype=torch.float32).transpose(1, 2)
        k, v = (randn((B, T, K, D), dtype=torch.float32).transpose(1, 2)
                for _ in "kv")
        keep = (torch.arange(S, device=device)[:, None]
                - torch.arange(T, device=device)[None, :])
        mask = (keep >= 0) if causal else torch.ones_like(keep, dtype=bool)
        if window:
            mask &= keep < window
        shape = f"{(B, H, K, S, T, D)} causal {causal} window {window}"
        for i in range(a.passes):
            tag = f" pass {i + 1}" if a.passes > 1 else ""
            for name in names if i % 2 == 0 else names[::-1]:
                saved = use(name, fa, fa.SOURCE, fa._bind)
                out[f"{name} {shape}{tag}"] = chip_smoke.median_event_ms(
                    lambda: ops.flash_attention(q, k, v, causal=causal,
                                                window=window),
                    n=2, repeats=5)
                restore(fa, saved)
            out[f"fa32 sdpa {shape}{tag}"] = chip_smoke.median_event_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True),
                n=2, repeats=5)
        del q, k, v, mask
    flash = [n for n in chosen if n.split()[0] == "flash"]
    for B, H, K, S, D in FLASH_SHAPES if flash else ():
        q = randn((B, S, H, D)).transpose(1, 2)
        k, v = (randn((B, S, K, D)).transpose(1, 2) for _ in "kv")
        for name in flash:
            saved = use(name, fa, fa.WGMMA_SOURCE, fa._bind_wgmma)
            for causal in (True, False):
                out[f"{name} {(B, H, K, S, D)} causal {causal}"] = \
                    chip_smoke.median_event_ms(
                        lambda: ops.flash_attention(q, k, v, causal=causal),
                        n=5, repeats=10)
            restore(fa, saved)
        del q, k, v
    build._libs.clear()
    text = json.dumps(out, indent=1)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / out_name).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
