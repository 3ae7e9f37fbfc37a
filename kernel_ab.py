#!/usr/bin/env python3
"""Time this tree's kernels B1 (feature splat), B2 (fused LN -> MLP) and
B5 (attention) against other builds of them, in one call on one NVIDIA
card, in turns.

    python3 kernel_ab.py --old DIR [--old DIR ...] [--variant NAME ...]
                         [--rounds 2] [--kernels ln_mlp]

Each DIR holds another checkout of the repo (for example
`git archive <commit> | tar -x -C DIR`), or only the sources to compare
(DIR/ln_mlp.cu). Each --variant NAME is an edit of this tree's
csrc/ln_mlp.cu from VARIANTS below, written under build/ and built like a
DIR. Every other build is made with this tree's nvcc flags (all at once)
and bound in place of this tree's library behind the same wrapper
(adapters where an older C interface differs), so every build runs on the
same inputs through the same Python. At chip_smoke.py's kernel shapes (B1:
the scatter entry over 65,536 slots and the dense entry over 349,966 rows,
F = 8, 5x7 patches, C = 512; B2: the four ConvNeXt-L stages of the kMaX
path, CLIP vision [14,000, 768] and text [231, 512], bf16 and f32; B5:
[280, 12, 50, 64] f32 and bf16, [3, 8, 77, 64] causal f32) each round
times every build forward, this tree's last, then backward (old, new,
new, old for one DIR; chip_smoke's `time_ms`: CUDA events, calls queued
behind a device sleep), and the library yardstick (torch.sparse.mm; two
cuBLAS addmm; scaled_dot_product_attention) once per round. Each build's
output is held against the plain version with chip_smoke's limits; B2's
f32 outputs of every build must be bitwise equal to this tree's. B2's
lines also time each build's weight pass alone. B5's lines also time a
copy of the qkv tensor and of the three head views (torch's copy kernel;
the rate this card gives these layouts). A build's numbers are keyed by
its label: `old` for a single DIR, else DIR's base name, and the
variant's name. Prints one JSON line per shape, the card's name and power
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


# Edits of this tree's csrc/<kernel>.cu that --variant builds: (kernel,
# [(text, replacement, occurrences)]); each text must occur exactly so often
VARIANTS = {
    # B2 bf16 with a single CTA a cluster: no weight multicast
    "no_multicast": ("ln_mlp", [(
        "constexpr int kCluster = 2;", "constexpr int kCluster = 1;", 1)]),
    # B2 bf16 releasing every stage with a cluster-scope arrive
    "release_cluster": ("ln_mlp", [(
        "mbarrier.arrive.shared::cluster.b64",
        "mbarrier.arrive.release.cluster.shared::cluster.b64", 1)]),
    # B2 bf16's activations on the library's erff / expf
    "library_erf": ("ln_mlp", [(
        "activate_bf16<ACT>(", "activate<ACT>(", 6)]),
}


def variant_source(name):
    """Write variant `name` of this tree's source under
    build/sai_torch_kernels/ab/<name>/; returns its directory."""
    from spatially_aware_ai_tpu_torch import native_cuda

    kernel, edits = VARIANTS[name]
    with open(os.path.join(native_cuda.CSRC_DIR, f"{kernel}.cu")) as f:
        text = f.read()
    for old, new, count in edits:
        if text.count(old) != count:
            raise RuntimeError(f"variant {name}: {old!r} occurs "
                               f"{text.count(old)} times, not {count}")
        text = text.replace(old, new)
    out_dir = os.path.join(native_cuda.build_dir(), "ab", name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{kernel}.cu"), "w") as f:
        f.write(text)
    return out_dir


def source_in(root, name):
    """csrc/<name>.cu of the tree at root, or root/<name>.cu."""
    alone = os.path.join(root, f"{name}.cu")
    if os.path.exists(alone):
        return alone
    return os.path.join(root, "spatially_aware_ai_tpu_torch", "csrc",
                        f"{name}.cu")


def build_all(jobs):
    """Build each (label, name, source) into build/sai_torch_kernels/ab/
    with this tree's flags, all at once; returns {(label, name): (library,
    ptxas lines)}."""
    from spatially_aware_ai_tpu_torch import native_cuda

    out_dir = os.path.join(native_cuda.build_dir(), "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for label, name, src in jobs:
        lib = os.path.join(out_dir, f"lib{label}_{name}.so")
        procs[label, name] = (subprocess.Popen(
            [native_cuda.nvcc_path(), *native_cuda.NVCC_FLAGS, "-Xptxas",
             "-v", "-I", os.path.dirname(src), "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib)
    out = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {key}:\n{log[-4000:]}")
        out[key] = (ctypes.CDLL(lib), [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln])
    return out


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


class _PlaneSplit:
    """An ln_mlp library from before the bf16 cast pass (commit afe7f4a and
    older: bf16 planes from the split pass, K permuted on route 2, and a
    split pass that takes the output dtype) behind this tree's wrapper,
    which asks for both bf16 planes with one sai_ln_mlp_cast and for f32
    planes without the dtype argument. The bf16 planes are made as that
    tree's wrapper made them, one split launch per weight in its K order."""

    # that tree's split modes for bf16 (w1, w2) by route
    MODES = {1: (0, 1), 2: (2, 2)}

    def __init__(self, lib, signatures):
        self.lib = lib
        self.sai_ln_mlp = lib.sai_ln_mlp
        self.sai_ln_mlp.restype, self.sai_ln_mlp.argtypes = \
            signatures["sai_ln_mlp"]
        self.split = lib.sai_ln_mlp_split
        self.split.restype = ctypes.c_int
        self.split.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.sai_ln_mlp_route.restype = ctypes.c_int
        lib.sai_ln_mlp_route.argtypes = [ctypes.c_int, ctypes.c_int]

    def sai_ln_mlp_split(self, src, src_bf16, sn, sk, N, K, mode, planes,
                         stream):
        return self.split(src, src_bf16, sn, sk, N, K, 0, mode, planes,
                          stream)

    def sai_ln_mlp_cast(self, w1, w1_bf16, sn1, sk1, w2, w2_bf16, sn2, sk2,
                        D, H, p1, p2, stream):
        m1, m2 = self.MODES[self.lib.sai_ln_mlp_route(D, H)]
        return (self.split(w1, w1_bf16, sn1, sk1, H, D, 1, m1, p1, stream)
                or self.split(w2, w2_bf16, sn2, sk2, D, H, 1, m2, p2,
                              stream))


def bind(lib, name, signatures):
    if name == "feature_splat" and not hasattr(lib,
                                               "sai_feature_splat_slice"):
        return _ScratchFree(lib)
    if name == "ln_mlp" and not hasattr(lib, "sai_ln_mlp_cast"):
        return _PlaneSplit(lib, signatures)
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def _mlp_cases(CS):
    """B2's shapes on the kMaX and CLIP paths: (D, M, act, eps, gamma,
    launches per path_kmax_bf16 run)."""
    for D, M, launches in CS.CONVNEXT_PATH_SHAPES:
        yield D, M, "gelu", 1e-6, True, launches
    yield 768, 14000, "quick_gelu", 1e-5, False, 48
    yield 512, 231, "quick_gelu", 1e-5, False, 12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", action="append", default=[],
                    help="another tree's root, or a directory of sources")
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS),
                    help="an edit of this tree's source (VARIANTS)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", default="feature_splat,attention")
    args = ap.parse_args(argv)
    which = args.kernels.split(",")
    if not args.old and not args.variant:
        ap.error("give --old or --variant")

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from spatially_aware_ai_tpu_torch import native_cuda
    from spatially_aware_ai_tpu_torch.grid import splat as S
    from spatially_aware_ai_tpu_torch.models import attention as A
    from spatially_aware_ai_tpu_torch.models import ln_mlp as L

    mods = {"feature_splat": S, "ln_mlp": L, "attention": A}
    jobs = []
    for root in args.old:
        label = ("old" if len(args.old) == 1
                 else os.path.basename(os.path.normpath(root)))
        jobs += [(label, name, source_in(root, name)) for name in which]
    for variant in args.variant:
        kernel = VARIANTS[variant][0]
        if kernel in which:
            jobs.append((variant, kernel,
                         source_in(variant_source(variant), kernel)))
    built = build_all(jobs)
    dev = torch.device("cuda")
    # {kernel: {label: library}}, this tree's last
    libs = {name: {} for name in which}
    for (label, name), (lib, ptxas) in built.items():
        libs[name][label] = bind(lib, name, mods[name]._SIGNATURES)
        print(json.dumps({"built": label, "kernel": name, "ptxas": ptxas}),
              flush=True)
    for name in which:
        libs[name]["new"] = native_cuda.load(name, mods[name]._SIGNATURES)

    def timed(name, fn):
        """{label: [ms, ...]} over rounds of every build forward, then
        backward (old, new, new, old for one other build)."""
        order = list(libs[name])
        out = {label: [] for label in order}
        for _ in range(args.rounds):
            for label in order + order[::-1]:
                native_cuda._LIBS[name] = libs[name][label]
                out[label].append(CS.time_ms(fn))
        native_cuda._LIBS[name] = libs[name]["new"]
        return out

    def outputs(name, fn):
        got = {}
        for label, lib in libs[name].items():
            native_cuda._LIBS[name] = lib
            got[label] = fn()
        native_cuda._LIBS[name] = libs[name]["new"]
        return got

    def medians(line, key="ms"):
        for label, times in line[key].items():
            line[f"{label}_{key}"] = statistics.median(times)

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
        medians(line)
        line.update(CS.splat_numbers(inputs, line["new_ms"]))
        ok &= line["ok"]
        print(json.dumps(line), flush=True)
    del cases

    for D, M, act, eps, gamma, launches in _mlp_cases(CS):
        if "ln_mlp" not in which:
            break
        for dt in (torch.bfloat16, torch.float32):
            mlp = CS._mlp_args(gen, dev, M, D, gamma, dt)
            w1, w2 = mlp[4], mlp[6]
            kw = dict(act=act, eps=eps)
            want = L.ln_mlp_plain(*mlp, **kw).float()
            got = outputs("ln_mlp", lambda: L.fused_ln_mlp(*mlp, **kw))
            atol, rtol = (3e-4, 0.0) if dt == torch.float32 else (3e-2, 2e-2)
            line = {"kernel": "ln_mlp", "dtype": str(dt)[6:], "M": M,
                    "D": D, "H": 4 * D, "act": act, "route": L.route(D, 4 * D),
                    "launches_per_path_run": launches,
                    "max_abs_err": {}, "ok": True}
            for tree, g in got.items():
                diff = (g.float() - want).abs()
                line["max_abs_err"][tree] = float(diff.max())
                line["ok"] &= bool((diff <= atol + rtol * want.abs()).all())
            if dt == torch.float32:
                line["f32_bitwise_equal"] = {
                    tree: torch.equal(g, got["new"])
                    for tree, g in got.items() if tree != "new"}
                line["ok"] &= all(line["f32_bitwise_equal"].values())
            del got, want
            line["ms"] = timed("ln_mlp", lambda: L.fused_ln_mlp(*mlp, **kw))
            line["split_ms"] = timed("ln_mlp", CS._b2_planes_fn(w1, w2, dt))
            if dt == torch.bfloat16:
                lib = CS._b2_library_fn(mlp, act, eps)
                line["library_ms"] = [CS.time_ms(lib)
                                      for _ in range(args.rounds)]
                del lib
            medians(line)
            medians(line, "split_ms")
            line["bound_ms"], line["bound_by"] = CS._b2_bound(M, D, 4 * D,
                                                              dt)
            line["new_share_of_bound"] = line["bound_ms"] / line["new_ms"]
            line["l2_weight_bytes"] = CS._b2_weight_stream(
                M, D, 4 * D, mlp[0].element_size())
            ok &= line["ok"]
            print(json.dumps(line), flush=True)
            del mlp, w1, w2

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
        medians(line)
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
