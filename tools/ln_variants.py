"""ts::ln_cast and ts::ln_cast_bwd (bf16, on one CUDA card) as copies of
csrc/block_fusions.cu with a launch plan changed or a part of LnCastBwd
switched off, each built with nvcc and timed at
chip_smoke.FUSION_TIMED_ROWS (D 768), with and without the residual, held
(cold L2) and warm, with each kernel's device µs a call from
torch.profiler: the readings behind the plans csrc/block_fusions.cu
takes and behind its note on where the backward's time goes. Prints one
JSON line; needs nvcc and a card.

    python3 tools/ln_variants.py

The copies: the kernels as built; the forward's plans forced ("fwd_ring":
the ring at every row count; "fwd_wave": one warp a row at every row
count; "fwd_ring_2_an_sm": the ring at 2 blocks an SM, not 3); the
backward's grid at 1 or 3 blocks an SM, not 2 ("bwd_1_an_sm",
"bwd_3_an_sm"); the backward in parts: "empty" (each block inits its
barriers, meets, stops before any load: the launch floor, with
ColumnSums), "loads_only" (every tile is loaded and waited for, nothing
is computed), "no_columns" (the column phase left out), "no_rows" (the row
phase left out), "no_sums" (no ColumnSums launch). A copy is made by
replacing lines of the source; it raises when a line to replace is no
longer there once. The copies of a plan are checked against the kernels
as built (forward equal bytes, backward dx equal bytes and the column
sums within chip_smoke.FUSION_SUM_REL); the cut copies are timed only.
"""
import ctypes
import os
import subprocess
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import chip_smoke as c
from tensor_stream_torch import _build
from tensor_stream_torch.ops import block_fusions as bf

_ROWS = ("    // The row phase: warp w, the tile's row w; dh gamma and xhat "
         "stay in\n    // registers between the two passes.\n    if (warp < "
         "n) {",
         "    // The row phase: warp w, the tile's row w; dh gamma and xhat "
         "stay in\n    // registers between the two passes.\n    if (warp < "
         "n && stages < 0) {")
_COLUMNS = ("    // The column phase: this thread's columns over its subset's "
            "rows.\n    if (sub < subsets) {",
            "    // The column phase: this thread's columns over its subset's "
            "rows.\n    if (sub < subsets && stages < 0) {")
_RING = ("  return rows > static_cast<long long>(SmCount()) * "
         "kFwdBlocksPerSm * kWarps;",
         "  return rows >= 0;")
LN_VARIANTS = {
    "as_built": [],
    "fwd_ring": [_RING],
    "fwd_wave": [(_RING[0], "  return rows < 0;")],
    "fwd_ring_2_an_sm": [_RING, ("constexpr int kFwdBlocksPerSm = 3;",
                                 "constexpr int kFwdBlocksPerSm = 2;")],
    "bwd_1_an_sm": [("constexpr int kBwdBlocksPerSm = 2;",
                     "constexpr int kBwdBlocksPerSm = 1;")],
    "bwd_3_an_sm": [("constexpr int kBwdBlocksPerSm = 2;",
                     "constexpr int kBwdBlocksPerSm = 3;")],
    "empty": [("  if (lane == 0) {\n    for (int t = 0; t < stages && t < "
               "tiles; ++t) fetch(t);\n  }\n",
               "  if (stages > 0) return;\n")],
    "loads_only": [_ROWS, _COLUMNS],
    "no_columns": [_COLUMNS],
    "no_rows": [_ROWS],
    "no_sums": [("    LaunchSums<__nv_bfloat16>(partial, groups, d, nq, "
                 "dgamma, dbeta, db, with_bias, s);",
                 "    ;")],
}


def _bound(so):
    """Binds block_fusions' wrappers to the library at `so` (the argument
    types as ops/block_fusions.py sets them); returns what to restore."""
    kept = (bf._LIB, bf._build)
    bf._LIB = None
    bf._build = types.SimpleNamespace(load=lambda name: ctypes.CDLL(so))
    bf._lib()
    bf._build = kept[1]
    bf._GROUPS.clear()
    return kept


def _calls(x, y, yb, w, b, dh, dres, xp, mean, rstd, eps, bt):
    """The four timed calls, by kernel name."""
    ops = torch.ops.ts
    return {"ln_cast_residual": lambda: ops.ln_cast.residual(x, y, yb, w, b,
                                                             eps),
            "ln_cast": lambda: ops.ln_cast(x, w, b, eps, bt),
            "ln_cast_bwd_residual": lambda: ops.ln_cast_bwd.residual(
                dh, dres, xp, mean, rstd, w),
            "ln_cast_bwd": lambda: ops.ln_cast_bwd(dh, xp, mean, rstd, w)}


def _same(name, got, ref):
    """A plan's outputs against the kernels as built: equal bytes but for
    the backward's column sums (they move with the grid)."""
    if "bwd" not in name:
        return all(c.bytes_equal(a, b) for a, b in zip(got, ref))
    return (c.bytes_equal(got[0], ref[0])
            and max(c.rel_norm(a, b) for a, b in zip(got[1:], ref[1:]))
            <= c.FUSION_SUM_REL)


def ln_variants(device=None):
    """Each LN_VARIANTS copy at FUSION_TIMED_ROWS, the four calls of
    _calls: held ms, warm ms, the profiler's µs a kernel; the copies of a
    plan checked against the kernels as built (_same)."""
    device = device or torch.device("cuda", 0)
    out_dir = os.path.join(_build.BUILD_DIR, "ln_variants")
    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(_build.SRC_DIR, "block_fusions.cu")).read()
    procs = {}
    for name, cuts in LN_VARIANTS.items():
        text = src
        for old, new in cuts:
            if text.count(old) != 1:
                raise AssertionError(f"ln_variants {name}: the text to "
                                     f"change is not in block_fusions.cu "
                                     f"once")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"ln_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"libln_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.SRC_DIR,
             "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    d, eps, bt = 768, 1e-6, torch.bfloat16
    inputs = []
    for k, lead in enumerate(c.FUSION_TIMED_ROWS):
        x, y, yb, w, b = c.ln_case_inputs(lead, d, bt, bt, "contiguous",
                                          70 + k, device)
        dh = c._seeded(x.shape, 75 + k).to(device, bt)
        dres = c._seeded(x.shape, 76 + k).to(device, bt)
        with torch.no_grad():
            xp, h, mean, rstd = torch.ops.ts.ln_cast.residual(x, y, yb, w,
                                                              b, eps)
        inputs.append((lead, _calls(x, y, yb, w, b, dh, dres, xp, mean,
                                    rstd, eps, bt)))
    rows, want = [], {}
    kept = None
    try:
        for name, (so, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"ln_variants {name}: nvcc failed:\n{log}")
            kept = kept or (bf._LIB, bf._build)
            _bound(so)
            for lead, calls in inputs:
                for kernel, fn in calls.items():
                    with torch.no_grad():
                        ok = None
                        if not any(name.startswith(p) for p in
                                   ("empty", "loads", "no_")):
                            got = [t.clone() for t in fn()]
                            ref = want.setdefault((str(lead), kernel), got)
                            ok = _same(kernel, got, ref)
                        rows.append({
                            "variant": name, "kernel": kernel,
                            "rows_shape": list(lead), "checked": ok,
                            "ms": c.time_ms(fn, device)[0],
                            "warm_ms": c.time_ms(fn, device,
                                                 cold=False)[0],
                            "split_us": c.pass_split(fn)})
    finally:
        if kept is not None:
            bf._LIB, bf._build = kept
            bf._GROUPS.clear()
    c.emit({"phase": "ln_variants", "card": c.nvidia_smi(), "rows": rows})
    if any(r["checked"] is False for r in rows):
        raise AssertionError("ln_variants: a plan's copy left the outputs "
                             "of the kernels as built")
    return rows


if __name__ == "__main__":
    c.phase_env()
    ln_variants()
