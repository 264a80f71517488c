"""Build, check and time the port's flash attention, flash decode and
grouped matmul on the card, each check in a child process under a time
limit.

    python3 tools/torch_kernel_check.py [--ptxas]
        [--check [attention decode gmm]] [--time] [--parent DIR]
        [--timeout S]

``--ptxas`` compiles both flash attentions, both grouped matmuls and the
bf16 flash decode with ``-Xptxas -v`` and prints each kernel's
registers, shared memory and spills.
``--check`` runs ``chip_smoke.check_attention`` (flash attention and
flash decode), ``chip_smoke.check_decode`` (flash decode alone) and
``chip_smoke.check_gmm`` (both dtypes), or the ones named (every sweep and
path shape against the plain versions, under the script's tolerances, and
the two-launch bit checks), each in a child process killed after
``--timeout`` seconds: a kernel that waits on a barrier that never
completes fails its check instead of holding the card.  ``--time`` prints
the kernels' device ms per launch (CUDA events over back-to-back launches;
for attention and decode also replayed from a CUDA graph, device time
without the host's gaps) and host ms per call, beside
``scaled_dot_product_attention`` and ``torch.bmm``, at the path shapes
(``chip_smoke.TIME_ATTENTION``, ``TIME_MASKED_ATTENTION``, in f32 every
row of ``TIME_ATTENTION_F32`` beside SDPA in f32, every row of
``TIME_DECODES`` at the full cache and the live length, every row of
``TIME_GMM``, ``GMM_OFF_PATH`` and ``TIME_GMM_F32``, the f32 rows beside
``torch.bmm`` with TF32 off, and a small decode shape, ``HOST_PROBE``,
whose host ms is the wrapper's cost), and with ``--parent DIR`` (an
unpacked tree of another commit) the same shapes on that tree's kernels,
in turns: parent, this tree, this tree, parent (the f32 attention rows
are this tree's, passed to each child, so that both trees time the same
shapes).  Needs a card; exits 1 if
any step failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(kind: str, tree: Path, f32_rows: list) -> None:
    """Runs in the child process, with ``tree``'s modules first on the
    path; ``f32_rows`` are the f32 attention rows to time."""
    sys.path[:0] = [str(tree), str(tree / "src")]
    import torch

    import chip_smoke
    device = torch.device("cuda", 0)
    if kind == "check_attention":
        print(json.dumps({"path_max_abs": chip_smoke.check_attention(device)}))
    elif kind == "check_decode":
        print(json.dumps({"path_max_abs": chip_smoke.check_decode(device)}))
    elif kind == "check_gmm":
        out = chip_smoke.check_gmm(device)
        print(json.dumps({str(k): v for k, v in out.items()}))
    elif kind == "time":
        print("RESULT " + json.dumps(time_kernels(chip_smoke, device,
                                                  f32_rows)))
    else:
        raise ValueError(kind)


HOST_PROBE = ("host probe", (8, 8, 256, 4096), 20, 20)


def time_kernels(cs, device, f32_rows) -> dict:
    """Device ms per launch of the kernels and their library calls at the
    path shapes (the f32 attention at ``f32_rows``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    gen = torch.Generator(device).manual_seed(9)

    def randn(shape, scale=1.0, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=device).mul_(scale)

    out = {}
    rows = [(name, (B, H, K, S, S, D), True, 0, torch.bfloat16)
            for name, (B, H, K, S, D) in cs.TIME_ATTENTION]
    rows += [(*row, torch.bfloat16) for row in cs.TIME_MASKED_ATTENTION]
    rows += [(name, tuple(shape), causal, window, torch.float32)
             for name, shape, causal, window in f32_rows]
    for name, (B, H, K, S, T, D), causal, window, dtype in rows:
        q = randn((B, S, H, D), dtype=dtype).transpose(1, 2)
        k, v = (randn((B, T, K, D), dtype=dtype).transpose(1, 2)
                for _ in "kv")
        keep = (torch.arange(S, device=device)[:, None]
                - torch.arange(T, device=device)[None, :])
        mask = (keep >= 0) if causal else torch.ones_like(keep, dtype=bool)
        if window:
            mask &= keep < window
        def kernel(q=q, k=k, v=v, causal=causal, window=window):
            return ops.flash_attention(q, k, v, causal=causal, window=window)

        out[name] = {
            "ms": cs.median_event_ms(kernel, n=5, repeats=10),
            "graph_ms": cs.median_graph_ms(kernel, n=5, repeats=5),
            "host_ms": cs.median_host_ms(kernel, n=5, repeats=10),
            "sdpa_ms": cs.median_event_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=None if causal and not window
                    and S == T else mask, is_causal=causal and not window
                    and S == T, enable_gqa=True), n=5, repeats=10)}
        del q, k, v, mask
    for name, (B, K, G, T, D) in cs.TIME_DECODES:
        q = randn((B, K, G, D))
        k, v = (randn((B, T, K, D)).transpose(1, 2) for _ in "kv")
        for n in sorted({T, cs.DECODE_LIVE.get((B, K, G, T, D), T)}):
            lengths = torch.full((B,), n, dtype=torch.int32, device=device)
            mask = (torch.arange(T, device=device)[None, :]
                    < lengths[:, None])[:, None, None, :]
            q_h = q.reshape(B, K * G, 1, D)

            def kernel(q=q, k=k, v=v, lengths=lengths):
                return ops.flash_decode(q, k, v, lengths)

            def sdpa(q_h=q_h, k=k, v=v, mask=mask):
                return F.scaled_dot_product_attention(
                    q_h, k, v, attn_mask=mask, enable_gqa=True)

            out[f"{name} len {n}"] = {
                "ms": cs.median_event_ms(kernel, n=10, repeats=10),
                "graph_ms": cs.median_graph_ms(kernel, n=20, repeats=10),
                "host_ms": cs.median_host_ms(kernel, n=10, repeats=10),
                "sdpa_graph_ms": cs.median_graph_ms(sdpa, n=20, repeats=10)}
        del q, k, v
    torch.backends.cuda.matmul.allow_tf32 = False
    # HOST_PROBE: a call whose device time is far below its host time, so
    # that host_ms is the wrapper's own cost
    rows = [(*row, torch.bfloat16) for row in
            list(cs.TIME_GMM) + list(cs.GMM_OFF_PATH) + [HOST_PROBE]]
    rows += [(*row, torch.float32) for row in cs.TIME_GMM_F32]
    for name, (E, C, d, f), n, repeats, dtype in rows:
        x = randn((E, C, d), dtype=dtype)
        w = randn((E, d, f), d ** -0.5, dtype)
        out[f"gmm {name}"] = {
            "ms": cs.median_event_ms(lambda: ops.grouped_matmul(x, w), n=n,
                                     repeats=repeats),
            "host_ms": cs.median_host_ms(lambda: ops.grouped_matmul(x, w),
                                         n=n, repeats=repeats),
            "bmm_ms": cs.median_event_ms(lambda: torch.bmm(x, w), n=n,
                                         repeats=repeats)}
        del x, w
    return out


def run_child(kind: str, tree: Path, timeout: int, f32_rows=()):
    """(ok, last RESULT json or None) of one child process."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child", kind,
           "--tree", str(tree), "--f32-rows", json.dumps(list(f32_rows))]
    print(f"== {kind} on {tree}, limit {timeout} s", flush=True)
    try:
        proc = subprocess.run(cmd, timeout=timeout, capture_output=True,
                              text=True)
    except subprocess.TimeoutExpired as e:
        print((e.stdout or b"")[-4000:] if isinstance(e.stdout, str)
              else "", flush=True)
        print(f"!! {kind} timed out after {timeout} s", flush=True)
        return False, None
    lines = proc.stdout.splitlines()
    keep = [ln for ln in lines if not ln.startswith("check ")
            or "path" in ln or "gmm" in ln or "bit-identical" in ln]
    print("\n".join(keep[-80:]))
    if proc.returncode != 0:
        print(proc.stderr[-6000:])
        print(f"!! {kind} exited {proc.returncode}", flush=True)
        return False, None
    res = [ln[7:] for ln in lines if ln.startswith("RESULT ")]
    return True, json.loads(res[-1]) if res else None


def ptxas() -> list:
    """Starts one ``nvcc -Xptxas -v`` per source; ``ptxas_report`` reads
    them."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    nvcc = "/usr/local/cuda/bin/nvcc"
    out_dir = ROOT / "chiprun_out"
    lib_dir = ROOT / "build" / "ptxas"
    out_dir.mkdir(exist_ok=True)
    lib_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in ("flash_attention_wgmma.cu", "flash_attention.cu",
                 "grouped_matmul_tc.cu", "grouped_matmul.cu",
                 "flash_decode_tc.cu"):
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(lib_dir / f"{name}.so"), str(build.CSRC / name)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs


def ptxas_report(procs) -> bool:
    ok = True
    out_dir = ROOT / "chiprun_out"
    for name, p in procs:
        text = p.communicate()[0]
        (out_dir / f"{name}.ptxas.txt").write_text(text)
        print(f"== ptxas {name} (exit {p.returncode})")
        print("\n".join(ln for ln in text.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "error" in ln.lower() or "Compiling" in ln)[-6000:])
        ok &= p.returncode == 0
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--check", nargs="*",
                    choices=("attention", "decode", "gmm"),
                    help="the checks to run (attention and gmm when none "
                         "is named)")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--timeout", type=int, default=300)
    ap.add_argument("--child")
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--f32-rows", default="[]")
    a = ap.parse_args()
    if a.child:
        child(a.child, a.tree, json.loads(a.f32_rows))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    ok = True
    procs = ptxas() if a.ptxas else []
    checks = None if a.check is None else (a.check or ["attention", "gmm"])
    if checks or a.time:        # every source once, in parallel
        sys.path[:0] = [str(ROOT), str(ROOT / "src")]
        import chip_smoke
        try:
            print("built in s:", chip_smoke.build_kernels(), flush=True)
        except subprocess.CalledProcessError as e:
            print(f"!! build failed: {e}")
            ok = False
    ok &= ptxas_report(procs)
    if not ok:
        print("FAILED")
        return 1
    for kind in checks or ():
        ok &= run_child(f"check_{kind}", ROOT, a.timeout)[0]
    if a.time:
        turns = [ROOT, ROOT]
        if a.parent:
            turns = [a.parent, ROOT, ROOT, a.parent]
        results = []
        f32_rows = chip_smoke.TIME_ATTENTION_F32
        for tree in turns:
            good, res = run_child("time", tree, a.timeout, f32_rows)
            ok &= good
            results.append({"tree": str(tree), "ms": res})
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "kernel_times.json").write_text(
            json.dumps(results, indent=1))
        for r in results:
            print(json.dumps(r))
    print("OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
