"""The mid flash forward and the mid flash backward, and the short
forward's two kernels (bf16, on one CUDA card) as FLASH_VARIANTS reshape or
cut them, each copy built from its source with nvcc and timed at
FLASH_VARIANT_SHAPES beside the design as built: the readings behind the
design choices that csrc/flash_fwd.cu and csrc/flash_bwd.cu name. A study
is a source, its copies and its shapes: "flash_fwd" and "flash_bwd" cut
the mid designs into parts, "fwd_route" and "bwd_route" time the mid
design and the one it took over from ("tiled", "wgmma") at the same
shapes, the routing rule's readings; the backward's route study also
times the backward of scaled_dot_product_attention three times a shape
(the yardstick). "short_fwd" cuts FlashFwdPacked and FlashFwdShort into
parts at the factorized ViT-B's temporal shapes and times the packed
kernel's plans (stages, blocks an SM); "short_route" times the two
kernels at S = 1 to 8, the packing rule's readings. Prints one JSON line;
needs nvcc and a card.

    python3 tools/flash_variants.py [flash_fwd | flash_bwd | fwd_route |
                                     bwd_route | short_fwd | short_route ...]

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


# Cut and reshaped copies of the mid forward and the mid backward: the
# designs as built (None), the alternatives their headers name, and the
# kernels in parts (loads only: every TMA load lands, no product runs;
# products only: no load is issued or waited for, so the shared memory
# holds whatever it held; no exp: the softmax's exponentials left out; no
# dQ: the backward without its dQ products). A cut copy ends in "_only"
# and is timed, not checked.
_MID_WAITS = [("  sm90::MbarWait(qbar, 0);\n", ""),
              ("  sm90::MbarWait(kvbar + 8 * first, 0);\n", ""),
              ("      sm90::MbarWait(kvbar + 8 * ch, 0);\n", ""),
              ("      sm90::MbarWait(kvbar + 8 * last, 0);\n", "")]
_MID_NO_STATS = ("  constexpr int kLanes = kD / 8;\n  const int part = ct % "
                 "kLanes;\n  const __nv_bfloat16* og",
                 "  if (ct >= 0) return;\n  constexpr int kLanes = kD / 8;\n"
                 "  const int part = ct % kLanes;\n  const __nv_bfloat16* og")
_MID_PRODUCTS = [("      ProduceMid(&tq,",
                  "      if (slices < 0) ProduceMid(&tq,"),
                 ("  if (has_a) sm90::MbarWait(bar + 8 * ja, 0);\n  if "
                  "(has_b) sm90::MbarWait(bar + 8 * jb, 0);\n", ""),
                 ("    sm90::MbarWait(MidFull(bar, s), (u / kMidRing) & 1);\n",
                  ""),
                 _MID_NO_STATS]
_MID_MIN = "constexpr long long kMidMinKvHeads = 72;"
FLASH_VARIANTS = {
    "flash_fwd": {
        "mid": None,
        # Every chunk 64 columns wide, the last too.
        "mid_no_tail": [("const bool tail = hi - last * kMidRows <= kMidTail;",
                         "const bool tail = false;")],
        "mid_loads_only": [("  sm90::MbarWait(kvbar + 8 * first, 0);\n  if "
                            "(first < full_end) {",
                            "  for (int ch = first; ch <= last; ++ch)\n    "
                            "sm90::MbarWait(kvbar + 8 * ch, 0);\n  if "
                            "(first >= 0) return;\n  if (first < full_end) "
                            "{")],
        "mid_products_only": [("  if (threadIdx.x == 0) {\n    for (int x = "
                               "0; x < boxes; ++x) {",
                               "  if (threadIdx.x == 0 && boxes < 0) {\n    "
                               "for (int x = 0; x < boxes; ++x) {"),
                              *_MID_WAITS],
        # The launch floor: each block inits its barriers, meets, stops.
        "mid_empty_only": [("  __syncthreads();\n  if (threadIdx.x == 0) {\n"
                            "    for (int x = 0; x < boxes; ++x) {",
                            "  __syncthreads();\n  if (boxes > 0) return;\n"
                            "  if (threadIdx.x == 0) {\n    for (int x = 0; x "
                            "< boxes; ++x) {")],
        "mid_no_exp_only": [("const float x = sm90::Exp2(fmaf(s[4 * j + 2 * "
                             "r + e], c2, -mc));",
                             "const float x = fmaf(s[4 * j + 2 * r + e], c2, "
                             "-mc);")]},
    "flash_bwd": {
        "mid": None,
        "mid_empty_only": [("  __syncthreads();\n  if (threadIdx.x < 128) "
                            "{\n    sm90::SetMaxRegsDec<kProducerRegs>();\n"
                            "    if (threadIdx.x == 0)\n      ProduceMid(",
                            "  __syncthreads();\n  if (slices > 0) return;\n"
                            "  if (threadIdx.x < 128) {\n    sm90::"
                            "SetMaxRegsDec<kProducerRegs>();\n    if "
                            "(threadIdx.x == 0)\n      ProduceMid(")],
        "mid_loads_only": [("const bool la = has_a && live(ja), lb = has_b && "
                            "live(jb);", "const bool la = false, lb = false;"),
                           ("    if (u % 2 == wg)\n",
                            "    if (u % 2 == wg && slices < 0)\n")],
        "mid_no_dq_only": [("    if (u % 2 == wg)\n",
                            "    if (u % 2 == wg && slices < 0)\n")],
        "mid_no_stats_only": [_MID_NO_STATS],
        "mid_products_only": _MID_PRODUCTS,
        # The products-only cut with one more part left out: the proxy
        # fence before the dV, dK products read P^T and dS^T, the
        # exponentials and dS, the warpgroup's meeting, the dQ products.
        "mid_products_no_fence_only": _MID_PRODUCTS + [
            ("  sm90::FenceProxyAsync();  // the stores, before wgmma reads "
             "them\n", "")],
        "mid_products_no_elementwise_only": _MID_PRODUCTS + [
            ("  st.Probs(sT);\n", ""), ("  st.Grads(sT, dpT);\n", "")],
        "mid_products_no_wg_meeting_only": _MID_PRODUCTS + [
            ("  MidWgSync(wg);\n}", "}")],
        "mid_products_no_dq_only": _MID_PRODUCTS + [
            ("    if (u % 2 == wg)\n",
             "    if (u % 2 == wg && slices < 0)\n")]},
    # The mid designs against the ones they took the range from, each
    # forced at every shape of the study.
    "fwd_route": {
        "mid": None,
        "tiled": [("  return d <= 64 && sq <= kMidMax && sk <= kMidMax ? 3 : "
                   "0;", "  return 0;")]},
    "bwd_route": {
        "mid": [(_MID_MIN, "constexpr long long kMidMinKvHeads = 0;")],
        "wgmma": [("        (H == Hk || static_cast<long long>(B) * Hk >= "
                   "kMidMinKvHeads))\n      return 4;",
                   "        false)\n      return 4;")]},
}
# The short forward: FlashFwdPacked as built, cut (loads only: each tile's
# copies land, nothing is computed or stored; no products: the mma.sync
# products left out, the rest as built; the launch floor: each warp stops
# at once) and in other plans (one slot a warp: load, then compute; three
# slots; 1, 2 or 4 blocks an SM), and FlashFwdShort forced at the same
# shapes, whole and cut the same ways.
_FORCE_SHORT = ("  return p.H == p.Hk && p.Sq == p.Sk && p.Sq <= kPackMax;",
                "  return false;")
_WARP = "  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n"
_PACKED_START = (_WARP + "  __nv_bfloat16* ring",
                 "  if (pack > 0) return;\n" + _WARP + "  __nv_bfloat16* ring")
_SHORT_START = (_WARP + "  __nv_bfloat16* stage",
                "  if (heads > 0) return;\n" + _WARP + "  __nv_bfloat16* stage")
FLASH_VARIANTS.update({
    "short_fwd": {
        "packed": None,
        "packed_loads_only": [("    __nv_bfloat16* qs = ring + u % kPackStages"
                               " * 3 * kTile;\n", "    if (pack > 0) continue;"
                               "\n    __nv_bfloat16* qs = ring + u % "
                               "kPackStages * 3 * kTile;\n")],
        "packed_no_products_only": [
            ("      Mma(sc[0], qa, bk[0], bk[1]);\n      Mma(sc[1], qa, bk[2], "
             "bk[3]);\n", ""),
            ("      Mma(o[n0 / 8], pa[0], bv[0], bv[1]);\n      Mma(o[n0 / 8 + "
             "1], pa[0], bv[2], bv[3]);\n", "")],
        "packed_empty_only": [_PACKED_START],
        "packed_one_stage": [("constexpr int kPackStages = 2;",
                              "constexpr int kPackStages = 1;")],
        "packed_three_stages": [("constexpr int kPackStages = 2;",
                                 "constexpr int kPackStages = 3;")],
        **{f"packed_{n}_blocks_an_sm": [(
            "constexpr int kPackBlocksPerSm = 3;",
            f"constexpr int kPackBlocksPerSm = {n};")] for n in (1, 2, 4)},
        "short": [_FORCE_SHORT],
        "short_loads_only": [_FORCE_SHORT, (
            "  mma_sync::CpAsyncWait<0>();\n  __syncthreads();\n\n  const int "
            "g = lane >> 2, c = lane & 3;", "  mma_sync::CpAsyncWait<0>();\n  "
            "__syncthreads();\n  if (heads > 0) return;\n\n  const int g = "
            "lane >> 2, c = lane & 3;")],
        "short_no_products_only": [_FORCE_SHORT, (
            "        Mma(s[2 * np], qa[kk], bk[0], bk[1]);\n        Mma(s[2 * np"
            " + 1], qa[kk], bk[2], bk[3]);\n", ""), (
            "        Mma(o[n0 / 8], pa[np], bv[0], bv[1]);\n        Mma(o[n0 / 8"
            " + 1], pa[np], bv[2], bv[3]);\n", "")],
        "short_empty_only": [_FORCE_SHORT, _SHORT_START]},
    # The packing rule: both kernels at S = 1 to 8 over 6,272 tokens of
    # ViT-B's 12 heads (spare rows at S = 3, 5, 6 and 7).
    "short_route": {"packed": None, "short": [_FORCE_SHORT]},
})
# The source a study copies, and the kernels whose ptxas lines it reports.
STUDY_SOURCE = {"flash_fwd": "flash_fwd", "flash_bwd": "flash_bwd",
                "fwd_route": "flash_fwd", "bwd_route": "flash_bwd",
                "short_fwd": "flash_fwd", "short_route": "flash_fwd"}
STUDY_KERNELS = {"flash_fwd": ("FlashFwdMid",), "fwd_route": ("FlashFwdMid",),
                 "flash_bwd": ("FlashBwdMid",), "bwd_route": ("FlashBwdMid",),
                 "short_fwd": ("FlashFwdPacked", "FlashFwdShort"),
                 "short_route": ("FlashFwdPacked", "FlashFwdShort")}

FLASH_VARIANT_SHAPES = {
    # name, (b, h, hk, sq, sk, d), causal, window
    "flash_fwd": (("twin_spatial", (32, 6, 6, 196, 196, 64), False, None),
                  ("vit_b_spatial", (32, 12, 12, 196, 196, 64), False, None)),
    "flash_bwd": (("vit_b_spatial", (32, 12, 12, 196, 196, 64), False, None),
                  ("twin_spatial_gqa", (32, 6, 2, 196, 196, 64), False,
                   None)),
    # The forward's band, where a 64-row tile of the mid design is 40%
    # live, beside the headline.
    "fwd_route": (("vit_b_spatial", (32, 12, 12, 196, 196, 64), False, None),
                  ("mid_band_150", (32, 12, 12, 150, 150, 64), False, 32)),
    # The backward's (batch, kv head) pairs, a block each in the mid
    # design, from 12 to 384 at S = 196, MHA and GQA 12:4, 6:2 and 12:2,
    # and the two ends of the range.
    "bwd_route": tuple(
        (f"b{b}_h{h}_hk{hk}_s{s}", (b, h, hk, s, s, 64), False, None)
        for b, h, hk, s in ((1, 12, 12, 196), (2, 12, 12, 196),
                            (4, 12, 12, 196), (6, 12, 12, 196),
                            (8, 12, 12, 196), (11, 12, 12, 196),
                            (16, 12, 12, 196), (32, 6, 6, 196),
                            (32, 12, 12, 196), (8, 12, 4, 196),
                            (16, 12, 4, 196), (24, 12, 4, 196),
                            (32, 12, 4, 196), (32, 6, 2, 196),
                            (64, 6, 2, 196), (32, 12, 2, 196),
                            (4, 12, 12, 100), (32, 12, 12, 100),
                            (4, 12, 12, 256), (16, 12, 12, 256))),
    # The factorized ViT-B's temporal attention at 8 and 16 frames.
    "short_fwd": (("vit_b_temporal_8f", (1568, 12, 12, 4, 4, 64), False,
                   None),
                  ("vit_b_temporal", (784, 12, 12, 8, 8, 64), False, None)),
    "short_route": tuple(
        (f"s{s}", (6272 // s, 12, 12, s, s, 64), False, None)
        for s in range(1, 9))}


def flash_variants(device=None, studies=tuple(FLASH_VARIANTS)):
    """The mid forward and the mid backward as the studies' FLASH_VARIANTS
    reshape or cut them, timed at their FLASH_VARIANT_SHAPES (bf16, the
    models' views), each beside its ptxas registers and spills; a whole
    variant is also held to its rule (flash_rule, bwd_rule) against the
    plain version. Builds each copy with nvcc under build/, binds it in
    place of the library for its calls, and restores the library after.
    The bwd_route study adds SDPA's backward, three reads a shape."""
    device = device or torch.device("cuda", 0)
    out_dir = os.path.join(_build.BUILD_DIR, "flash_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for study in studies:
        source = STUDY_SOURCE[study]
        variants = FLASH_VARIANTS[study]
        src = open(os.path.join(_build.SRC_DIR, f"{source}.cu")).read()
        for name, cuts in variants.items():
            text = src
            for old, new in cuts or ():
                if text.count(old) != 1:
                    raise AssertionError(f"flash_variants {name}: the text to "
                                         f"change is not in {source}.cu once")
                text = text.replace(old, new)
            cu = os.path.join(out_dir, f"{study}_{name}.cu")
            with open(cu, "w") as f:
                f.write(text)
            so = os.path.join(out_dir, f"lib{study}_{name}.so")
            procs[study, name] = (so, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                 _build.SRC_DIR, "-o", so, cu], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    fa._kernel(), fa._bwd_kernel()
    kept = (fa._FN, fa._BWD_FN, fa._BWD_DESIGN_FN)
    rows = []
    try:
        for (study, name), (so, proc) in procs.items():
            source = STUDY_SOURCE[study]
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"flash_variants {name}: nvcc failed:\n"
                                   f"{log}")
            lines = log.splitlines()
            names = STUDY_KERNELS[study]
            warnings = sorted({ln.split("(")[1][:5] for ln in lines if
                               "(C75" in ln and any(k in ln for k in names)})
            ptxas = [f"{k}{ln.split(k)[1][:5]}: {lines[i + 3]}"
                     f" {lines[i + 2].strip()}"
                     for i, ln in enumerate(lines) for k in names
                     if "Compiling entry" in ln and k in ln]
            lib = ctypes.CDLL(so)
            if source == "flash_fwd":
                fn = lib.ts_flash_fwd
                fn.restype, fn.argtypes = kept[0].restype, kept[0].argtypes
                fa._FN = fn
            else:
                fa._FN = kept[0]  # the backward's residuals from the library
                fn, design = lib.ts_flash_bwd, lib.ts_flash_bwd_design
                fn.restype, fn.argtypes = kept[1].restype, kept[1].argtypes
                design.restype = kept[2].restype
                design.argtypes = kept[2].argtypes
                fa._BWD_FN, fa._BWD_DESIGN_FN = fn, design
            whole = not name.endswith("_only")
            for case, shape, causal, window in FLASH_VARIANT_SHAPES[study]:
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
                rows.append({"study": study, "variant": name,
                             "case": case, "shape": list(shape),
                             "ptxas": ptxas, "ptxas_warnings": warnings,
                             "rule_ok": ok, "ms": ms,
                             "p10_ms": p10, "p90_ms": p90})
                if study.startswith("short"):
                    rows[-1]["plan"] = short_plan(lib, shape)
    finally:
        fa._FN, fa._BWD_FN, fa._BWD_DESIGN_FN = kept
    if "bwd_route" in studies:
        rows += [sdpa_bwd_reads(case, shape, device)
                 for case, shape, _, _ in FLASH_VARIANT_SHAPES["bwd_route"]]
    c.emit({"phase": "flash_variants", "card": c.nvidia_smi(), "rows": rows})
    return rows


def short_plan(lib, shape):
    """A copy's short forward plan at (b, h, hk, sq, sk, d), as its
    ts_flash_fwd_short_plan reports it (chip_smoke.flash_plan's keys)."""
    b, h, hk, sq, sk, d = shape
    keys = ("heads_a_tile", "heads_a_block", "blocks", "smem_a_block",
            "stages", "blocks_an_sm", "warps_a_block")
    out = (ctypes.c_int * len(keys))()
    fn = lib.ts_flash_fwd_short_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    if fn(d, b, h, hk, sq, sk, out) != 0:
        raise RuntimeError(f"short plan at {shape}: the copy's call failed")
    return dict(zip(keys, out))


def sdpa_bwd_reads(case, shape, device, reads=3):
    """The backward of scaled_dot_product_attention (no mask, GQA's kv
    heads as they are) at a bwd_route shape, timed `reads` times in a
    row on the inputs the study's backward gets: a row with each read's
    median and the median of those."""
    b, h, hk, sq, sk, d = shape
    q, k, v = c._flash_case(*shape, torch.bfloat16, 8, "bshd")
    do = c._grad_out(b, h, sq, d, torch.bfloat16, 9, "bshd")
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    gqa = {"enable_gqa": True} if hk != h else {}
    out = torch.nn.functional.scaled_dot_product_attention(*leaves, **gqa)
    got = [c.time_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), device) for _ in range(reads)]
    return {"study": "bwd_route", "variant": "sdpa", "case": case,
            "shape": list(shape), "reads_ms": [r[0] for r in got],
            "ms": sorted(r[0] for r in got)[reads // 2],
            "p10_ms": [r[1] for r in got], "p90_ms": [r[2] for r in got]}


if __name__ == "__main__":
    flash_variants(studies=sys.argv[1:] or tuple(FLASH_VARIANTS))
