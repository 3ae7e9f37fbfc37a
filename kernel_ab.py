#!/usr/bin/env python3
"""Time this tree's kernels B1 (feature splat) and B5 (attention) against
another tree's, in one call on one NVIDIA card, in turns.

    python3 kernel_ab.py --old DIR [--rounds 2] [--kernels attention]

DIR holds another checkout of the repo (for example
`git archive <commit> | tar -x -C DIR`). Its
spatially_aware_ai_tpu_torch/csrc/{feature_splat,attention}.cu are built
with this tree's nvcc flags and bound in place of this tree's libraries
behind the same wrappers (the C interfaces are the same), so both trees
run on the same inputs through the same Python. At chip_smoke.py's kernel
shapes (B1: the scatter entry over 65,536 slots and the dense entry over
349,966 rows, F = 8, 5x7 patches, C = 512; B5: [280, 12, 50, 64] f32 and
bf16, [3, 8, 77, 64] causal f32) each round times old, new, new, old
(chip_smoke's `time_ms`: CUDA events, calls queued behind a device sleep),
and the library yardstick (torch.sparse.mm; scaled_dot_product_attention)
once per round. Each tree's output is held against the plain version with
chip_smoke's limits. B5's lines also time a copy of the qkv tensor and
of the three head views (torch's copy kernel; the rate this card gives
these layouts). Prints one JSON line per shape, the card's name and power
limit from nvidia-smi, and last {"ok": ...}.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def build_old(old_root, name):
    """Build DIR's csrc/<name>.cu into build/sai_torch_kernels/ab/ with
    this tree's flags; returns (library, ptxas lines)."""
    from spatially_aware_ai_tpu_torch import native_cuda

    src = os.path.join(old_root, "spatially_aware_ai_tpu_torch", "csrc",
                       f"{name}.cu")
    out_dir = os.path.join(native_cuda.build_dir(), "ab")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libold_{name}.so")
    proc = subprocess.run(
        [native_cuda.nvcc_path(), *native_cuda.NVCC_FLAGS, "-Xptxas", "-v",
         "-I", os.path.dirname(src), "-o", lib, src],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src}:\n{proc.stdout}{proc.stderr}")
    log = proc.stdout + proc.stderr
    return ctypes.CDLL(lib), [ln.strip() for ln in log.splitlines()
                              if "registers" in ln or "spill" in ln]


class _ScratchFree:
    """A feature-splat library from before the compaction launch (no
    scratch argument, no sai_feature_splat_slice) behind this tree's
    wrapper, which passes a scratch buffer before the stream. It exists
    only to compare against such a tree (commit 37ab81f and older); remove
    it once no comparison against one is needed."""

    def __init__(self, lib):
        self.fn = lib.sai_feature_splat
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def sai_feature_splat(self, *args):
        return self.fn(*args[:10], args[11])


def bind(lib, name, signatures):
    if name == "feature_splat" and not hasattr(lib,
                                               "sai_feature_splat_slice"):
        return _ScratchFree(lib)
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", default="feature_splat,attention")
    args = ap.parse_args(argv)
    which = args.kernels.split(",")

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from spatially_aware_ai_tpu_torch import native_cuda
    from spatially_aware_ai_tpu_torch.grid import splat as S
    from spatially_aware_ai_tpu_torch.models import attention as A

    dev = torch.device("cuda")
    libs = {}
    for name, mod in (("feature_splat", S), ("attention", A)):
        if name not in which:
            continue
        new = native_cuda.load(name, mod._SIGNATURES)
        old, ptxas = build_old(args.old, name)
        libs[name] = {"new": new, "old": bind(old, name, mod._SIGNATURES)}
        print(json.dumps({"built_old": name, "ptxas": ptxas}), flush=True)

    def timed(name, fn):
        """{tree: [ms, ...]} over rounds of old, new, new, old."""
        out = {"old": [], "new": []}
        for _ in range(args.rounds):
            for tree in ("old", "new", "new", "old"):
                native_cuda._LIBS[name] = libs[name][tree]
                out[tree].append(CS.time_ms(fn))
        native_cuda._LIBS[name] = libs[name]["new"]
        return out

    def outputs(name, fn):
        got = {}
        for tree in ("old", "new"):
            native_cuda._LIBS[name] = libs[name][tree]
            got[tree] = fn()
        native_cuda._LIBS[name] = libs[name]["new"]
        return got

    ok = True
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = CS.splat_cases(gen, dev)
    for entry, fn, plain in (
            ("splat_scatter", S.splat_scatter, S.splat_scatter_plain),
            ("splat", S.splat, S.splat_plain)):
        if "feature_splat" not in which:
            break
        inputs = cases[entry]
        base = inputs[0]
        want = plain(base.clone(), *inputs[1:])
        got = outputs("feature_splat",
                      lambda: fn(base.clone(), *inputs[1:]))
        err = {t: float((g - want).abs().max()) for t, g in got.items()}
        del got, want
        line = {"kernel": "feature_splat", "entry": entry,
                "max_abs_err": err, "ok": max(err.values()) <= 1e-4}
        line["ms"] = timed("feature_splat", lambda: fn(*inputs))
        if entry == "splat_scatter":
            line["library_ms"] = [CS._sparse_mm_ms(inputs[2], inputs[3])
                                  for _ in range(args.rounds)]
        new_ms = statistics.median(line["ms"]["new"])
        line["old_ms"] = statistics.median(line["ms"]["old"])
        line["new_ms"] = new_ms
        line.update(CS.splat_numbers(inputs, new_ms))
        ok &= line["ok"]
        print(json.dumps(line), flush=True)
    del cases

    import torch.nn.functional as F
    for B, H, T, causal, dt in CS.attention_cases():
        if "attention" not in which:
            break
        qkv, q, k, v = CS.attention_inputs(gen, dev, B, H, T, dt)
        want = A.attention_plain(q, k, v, causal)
        got = outputs("attention", lambda: A.attention(q, k, v, causal))
        line = {"kernel": "attention", "B": B, "H": H, "T": T,
                "causal": causal, "dtype": str(dt)[6:]}
        if dt == torch.float32:
            line["max_abs_err"] = {t: float((g - want).abs().max())
                                   for t, g in got.items()}
            line["ok"] = max(line["max_abs_err"].values()) <= 1e-5
        else:
            line["max_bf16_ulps"] = {
                t: float(A.bf16_ulps(g.view(B, T, H, 64),
                                     want.view(B, T, H, 64)).max())
                for t, g in got.items()}
            line["ok"] = max(line["max_bf16_ulps"].values()) <= 2
        line["ms"] = timed("attention", lambda: A.attention(q, k, v, causal))
        line["library_ms"] = [CS.time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   is_causal=causal))
            for _ in range(args.rounds)]
        line["old_ms"] = statistics.median(line["ms"]["old"])
        line["new_ms"] = statistics.median(line["ms"]["new"])
        line["qkv_clone_ms"] = CS.time_ms(qkv.clone)
        line["views_copy_ms"] = CS.time_ms(
            lambda: (q.contiguous(), k.contiguous(), v.contiguous()))
        pairs = T * (T + 1) // 2 if causal else T * T
        line["bound_ms"], line["bound_by"] = CS._bound(
            4 * B * H * T * 64 * q.element_size(), 4.0 * B * H * pairs * 64,
            CS.PEAK_F32 if dt == torch.float32 else CS.PEAK_BF16)
        ok &= line["ok"]
        print(json.dumps(line), flush=True)
        del qkv, q, k, v, want, got

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
