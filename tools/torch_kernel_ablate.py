"""Ablations of the port's two warp-specialised bf16 kernels on the card:
each variant is the source with one part taken out, built beside the real
one and timed at a path shape, so that the difference says what that part
costs.  The variants' outputs are wrong by design; only their times count.

    python3 tools/torch_kernel_ablate.py [--dry]

Grouped matmul (``csrc/grouped_matmul_tc.cu``, the prefill kernel, at
Grok-1's (8, 320, 6144, 32768) and (8, 160, 6144, 32768)):
``release_cluster`` releases ring slots as the first design did, one
thread arriving at each CTA of the cluster with ``.release.cluster``
ordering; ``no_load`` issues no TMA copy (the producer arrives instead, so
the barriers still turn); ``no_mma`` issues no wgmma.

Flash attention (``csrc/flash_attention_wgmma.cu``, at Qwen3-4B's
(4, 32, 8, 2048, 128) and a D = 64 shape, (4, 25, 5, 2048, 64), causal and
not): ``no_softmax`` skips the max, the exponentials and the rescale;
``no_kv_load`` issues no copy of K or V (the producer arrives instead);
``pingpong_flip`` flips the choice of which head dims the consumer
warpgroups take turns at (the kernel: at D > 64 only); ``stages3`` deepens the K/V ring to 3 slots;
``one_cta_per_item`` launches the same kernel with a CTA per work item
instead of a persistent CTA per SM.

Prints the card's name and power limit and one JSON object of device ms
per launch (CUDA events, median), and writes it to
``chiprun_out/kernel_ablation.json``.  ``--dry`` only checks, without a
card, that every variant's edits apply to the sources.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from repro_torch.kernels import build  # noqa: E402

GMM = "grouped_matmul_tc.cu"
FLASH = "flash_attention_wgmma.cu"
# variant -> (source, [(text, replacement), ...])
VARIANTS = {
    "gmm base": (GMM, []),
    "gmm release_cluster": (GMM, [(
        "    if (tid < CS) mbar_arrive_cluster(empty + s, tid);",
        "    if (tid == 0)\n      for (int r = 0; r < CS; ++r)\n"
        "        asm volatile(\"{\\n.reg .b32 rem;\\n"
        "mapa.shared::cluster.u32 rem, %0, %1;\\n"
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [rem];\\n"
        "}\\n\" :: \"r\"(smem_addr(empty + s)), \"r\"(r) : \"memory\");")]),
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
         "mbar_arrive(full + s);")]),
    "gmm no_mma": (GMM, [("        wgmma_m64n160k16_ta(acc[h], da, db);",
                          "        (void)da;\n        (void)db;")]),
    "flash base": (FLASH, []),
    "flash no_softmax": (FLASH, [
        ("      softmax(k_lo, corr);", "      corr[0] = corr[1] = 1.f;"),
        ("        softmax(k_lo + t * kBKV, corr);",
         "        corr[0] = corr[1] = 1.f;")]),
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
         "          mbar_arrive(v_full + s);\n")]),
    "flash pingpong_flip": (FLASH, [
        ("constexpr bool kPingPong = DP > 64;",
         "constexpr bool kPingPong = DP <= 64;")]),
    "flash stages3": (FLASH, [("constexpr int kStages = 2;",
                               "constexpr int kStages = 3;")]),
    # the same source, launched with one CTA per work item
    "flash one_cta_per_item": (FLASH, []),
}
GMM_SHAPES = [(8, 320, 6144, 32768), (8, 160, 6144, 32768)]
FLASH_SHAPES = [(4, 32, 8, 2048, 128), (4, 25, 5, 2048, 64)]


def variant_source(name: str) -> str:
    """The source text of one variant; raises if an edit does not apply."""
    source, edits = VARIANTS[name]
    text = (build.CSRC / source).read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"{name}: {old[:60]!r} is not in {source}")
        text = text.replace(old, new)
    return text


def build_variant(name: str) -> Path:
    out = ROOT / "build" / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    stem = name.replace(" ", "_")
    src = build.CSRC / f"_ablate_{stem}.cu"     # beside the headers
    src.write_text(variant_source(name))
    lib = out / f"{stem}.so"
    try:
        subprocess.run(["/usr/local/cuda/bin/nvcc", *build.NVCC_FLAGS, "-o",
                        str(lib), str(src)], check=True)
    finally:
        src.unlink()
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dry", action="store_true")
    a = ap.parse_args()
    for name in VARIANTS:
        variant_source(name)
    if a.dry:
        print(f"{len(VARIANTS)} variants apply")
        return 0
    import torch

    import chip_smoke
    from repro_torch.kernels import flash_attention, grouped_matmul, ops
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    print(chip_smoke.nvidia_smi())
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    device = torch.device("cuda", 0)
    gen = torch.Generator(device).manual_seed(0)

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, dtype=torch.bfloat16,
                           device=device).mul_(scale)

    def use(name, source, bind):
        lib = ctypes.CDLL(str(libs[name]))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        bind(lib)
        build._libs[source] = lib

    out = {}
    sms = flash_attention.SMS
    for E, C, d, f in GMM_SHAPES:
        x, w = randn((E, C, d)), randn((E, d, f), d ** -0.5)
        for name in (n for n in VARIANTS if n.startswith("gmm")):
            use(name, grouped_matmul.TC_SOURCE, grouped_matmul._bind_tc)
            out[f"{name} {(E, C, d, f)}"] = chip_smoke.median_event_ms(
                lambda: ops.grouped_matmul(x, w), n=5, repeats=5)
        del x, w
    for B, H, K, S, D in FLASH_SHAPES:
        q = randn((B, S, H, D)).transpose(1, 2)
        k, v = (randn((B, S, K, D)).transpose(1, 2) for _ in "kv")
        for name in (n for n in VARIANTS if n.startswith("flash")):
            use(name, flash_attention.WGMMA_SOURCE,
                flash_attention._bind_wgmma)
            flash_attention.SMS = 2 ** 30 if "per_item" in name else sms
            for causal in (True, False):
                out[f"{name} {(B, H, K, S, D)} causal {causal}"] = \
                    chip_smoke.median_event_ms(
                        lambda: ops.flash_attention(q, k, v, causal=causal),
                        n=5, repeats=10)
        del q, k, v
    build._libs.clear()
    text = json.dumps(out, indent=1)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "kernel_ablation.json").write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
