"""The mid flash forward and the short flash backward (bf16, on one
CUDA card) as FLASH_VARIANTS reshape or cut them, each copy built from
its source with nvcc and timed at FLASH_VARIANT_SHAPES beside the design
as built: the readings behind the design choices that csrc/flash_fwd.cu
and csrc/flash_bwd.cu name. Prints one JSON line; needs nvcc and a card.

    python3 tools/flash_variants.py

A copy is made by replacing lines of the source; it raises when a line to
replace is no longer there once.
"""
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import chip_smoke as c
from tensor_stream_torch import _build
from tensor_stream_torch.ops import flash_attention as fa


# Cut and reshaped copies of the mid forward and the short backward: the
# designs as built (None), the alternatives their headers name, and the
# kernels in parts (loads only: no product runs; products only: no global
# read of K and V, or of Q and dO, so the shared memory holds zeros; no
# exp: the softmax's exponentials left out). A cut copy ends in "_only"
# and is timed, not checked.
FLASH_VARIANTS = {
    "flash_fwd": {
        "mid": None,
        "mid_chunk64": [("constexpr int kMidChunk = 32;",
                         "constexpr int kMidChunk = 64;")],
        "mid_warps4": [("constexpr int kMidWarps = 7;",
                        "constexpr int kMidWarps = 4;")],
        "mid_warps8": [("constexpr int kMidWarps = 7;",
                        "constexpr int kMidWarps = 8;"),
                       ("return D <= 64 ? 3 : 1;", "return D <= 64 ? 2 : 1;")],
        "mid_loads_only": [("c0 < hi; c0 += kMidChunk) {",
                            "c0 < -1; c0 += kMidChunk) {")],
        "mid_no_exp_only": [("const float x = sm90::Exp2(fmaf(s[j][2 * r + "
                             "e], c2, -mc));\n            s[j][2 * r + e] = "
                             "x;\n            sum += x;",
                             "const float x = s[j][2 * r + e];\n          "
                             "  sum += x;")],
        "mid_products_only": [("const bool in = r < p.Sk;\n      mma_sync::"
                               "CpAsync16(ks + r * LD",
                               "const bool in = false;\n      mma_sync::"
                               "CpAsync16(ks + r * LD")]},
    "flash_bwd": {
        "short": None,
        "short_unpacked": [("constexpr int kPackMax = 8;",
                            "constexpr int kPackMax = 0;")],
        "short_2_blocks_an_sm": [("D <= 64 ? 3 : 1)\n    FlashBwdShort",
                                  "D <= 64 ? 1 : 1)\n    FlashBwdShort")],
        "short_loads_only": [("  const int r0 = 16 * warp;  // this warp's "
                              "tile", "  if (pack > 0) return;\n  const int "
                              "r0 = 16 * warp;"),
                             ("    // dK, dV: this warp's kv slice against "
                              "its q heads of the step.",
                              "    if (group > 0) continue;")],
        "short_products_only": [("const bool in = row_of(r, &head, &lr);\n"
                                 "    const int b",
                                 "const bool in = row_of(r, &head, &lr) && "
                                 "pack < 0;\n    const int b"),
                                ("p.st[kQ][2], 0, sqp, p.Sq);",
                                 "p.st[kQ][2], 0, sqp, 0);"),
                                ("p.st[kDo][2], 0, sqp, p.Sq);",
                                 "p.st[kDo][2], 0, sqp, 0);")]},
}
FLASH_VARIANT_SHAPES = {
    # name, (b, h, hk, sq, sk, d), causal, window
    "flash_fwd": (("twin_spatial", (32, 6, 6, 196, 196, 64), False, None),
                  ("vit_b_spatial", (32, 12, 12, 196, 196, 64), False, None)),
    "flash_bwd": (("vit_b_temporal", (1568, 12, 12, 4, 4, 64), False, None),
                  ("twin_temporal", (392, 6, 6, 16, 16, 64), True,
                   c.TWIN_RING),
                  ("twin_temporal_gqa", (392, 6, 2, 16, 16, 64), True,
                   c.TWIN_RING))}


def flash_variants(device=None):
    """The mid forward and the short backward as FLASH_VARIANTS reshape or
    cut them, timed at FLASH_VARIANT_SHAPES (bf16, the models' views),
    each beside its ptxas registers and spills; a whole variant is also
    held to its rule (flash_rule, bwd_rule) against the plain version.
    Builds each copy with nvcc under build/, binds it in place of the
    library for its calls, and restores the library after."""
    device = device or torch.device("cuda", 0)
    out_dir = os.path.join(_build.BUILD_DIR, "flash_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for source, variants in FLASH_VARIANTS.items():
        src = open(os.path.join(_build.SRC_DIR, f"{source}.cu")).read()
        for name, cuts in variants.items():
            text = src
            for old, new in cuts or ():
                if text.count(old) != 1:
                    raise AssertionError(f"flash_variants {name}: the text to "
                                         f"change is not in {source}.cu once")
                text = text.replace(old, new)
            cu = os.path.join(out_dir, f"{name}.cu")
            with open(cu, "w") as f:
                f.write(text)
            so = os.path.join(out_dir, f"lib{name}.so")
            procs[name] = (source, so, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                 _build.SRC_DIR, "-o", so, cu], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    fa._kernel(), fa._bwd_kernel()
    kept = (fa._FN, fa._BWD_FN, fa._BWD_DESIGN_FN)
    kernel = {"flash_fwd": "FlashFwdMid", "flash_bwd": "FlashBwd"}
    rows = []
    try:
        for name, (source, so, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"flash_variants {name}: nvcc failed:\n"
                                   f"{log}")
            lines = log.splitlines()
            ptxas = [f"{ln.split(kernel[source])[1][:12]}: {lines[i + 3]}"
                     f" {lines[i + 2].strip()}"
                     for i, ln in enumerate(lines)
                     if "Compiling entry" in ln and kernel[source] in ln]
            lib = ctypes.CDLL(so)
            if source == "flash_fwd":
                fn = lib.ts_flash_fwd
                fn.restype, fn.argtypes = kept[0].restype, kept[0].argtypes
                fa._FN = fn
            else:
                fn, design = lib.ts_flash_bwd, lib.ts_flash_bwd_design
                fn.restype, fn.argtypes = kept[1].restype, kept[1].argtypes
                design.restype = kept[2].restype
                design.argtypes = kept[2].argtypes
                fa._BWD_FN, fa._BWD_DESIGN_FN = fn, design
            whole = not name.endswith("_only")
            for case, shape, causal, window in FLASH_VARIANT_SHAPES[source]:
                b, h, hk, sq, sk, d = shape
                q, k, v = c._flash_case(*shape, torch.bfloat16, 8, "bshd")
                kw = {"causal": causal, "window": window}
                if source == "flash_fwd":
                    def call():
                        return fa.flash_attention_fwd(q, k, v, **kw)

                    def want():
                        return fa.flash_attention_plain(
                            q, k, v, causal, window, residuals=True)
                    rule = c.flash_rule
                else:
                    do = c._grad_out(b, h, sq, d, torch.bfloat16, 9, "bshd")
                    o, l, m = fa.flash_attention_fwd(q, k, v, **kw)

                    def call():
                        return fa.flash_attention_bwd(q, k, v, o, l, m, do,
                                                      **kw)

                    def want():
                        return fa.flash_attention_bwd_plain(
                            q, k, v, o, l, m, do, causal, window)
                    rule = c.bwd_rule
                ok = all(rule(call(), want())[0].values()) if whole else None
                ms, p10, p90 = c.time_ms(call, device)
                rows.append({"source": source, "variant": name,
                             "case": case, "shape": list(shape),
                             "ptxas": ptxas, "rule_ok": ok, "ms": ms,
                             "p10_ms": p10, "p90_ms": p90})
    finally:
        fa._FN, fa._BWD_FN, fa._BWD_DESIGN_FN = kept
    c.emit({"phase": "flash_variants", "card": c.nvidia_smi(), "rows": rows})
    return rows


if __name__ == "__main__":
    flash_variants()
