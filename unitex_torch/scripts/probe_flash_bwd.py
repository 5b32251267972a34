"""What bounds kernels B2a and B2b on the card: each is timed as built, and
again built from copies of ``csrc/flash_attn_bwd.cu`` with one cost taken
out.

    python -m unitex_torch.scripts.probe_flash_bwd [--seq 12800] [--heads 24]

Costs taken out (timing only: the gradients are wrong by construction):

- ``no_stream_copies``: after the ring's first fill the producer arrives
  on each stage's full barrier without copying (K and V in B2b, Q and dO
  in B2a), so the consumers run on stale tiles with no TMA traffic;
- ``no_exp2``: P is the raw score instead of exp2(S·s·log2 e − lse·log2 e);
- both.

A kernel whose time drops without the copies waits on its streamed tiles;
one that does not move is bound by its products and their shared-memory
operands.  The design choices, each undone in one variant (right
gradients): ``two_stage_dkv`` (B2a's ring of 2 stages, not 3),
``scores_first`` (a turn issues this tile's S and dP before the previous
tile's gradient product, and releases that tile after its own
arithmetic), ``no_turns`` (no named-barrier turns between the consumers)
and ``hoisted_bases`` (descriptors and dS store addresses free to be
hoisted out of the loop).  Each variant is built with nvcc from a
temporary copy of ``csrc/``; the card's name and power limit head the
output.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import tempfile

import torch

from ..ops import attention as attn
from ..utils import cuda_build


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"flash_attn_bwd.cu no longer holds {old!r}")
    return src.replace(old, new)


def no_stream_copies(src: str) -> str:
    for ring in ("vfull", "kfull"):
        src = _replace(src, f"mbar_expect_tx(bar.{ring}(s), kOwnBytes);",
                       f"mbar_expect_tx(bar.{ring}(s), j < kDqStages ? "
                       "kOwnBytes : 0);")
    for load in ("tma_load_4d(sV + s * kOwnBytes + x * kOwnBox, ",
                 "tma_load_4d(sK + s * kOwnBytes + x * kOwnBox, "):
        src = _replace(src, "          " + load,
                       "          if (j < kDqStages) " + load)
    src = _replace(src, "mbar_expect_tx(bar.full(s), 2 * kStreamBytes);",
                   "mbar_expect_tx(bar.full(s), i < kDkvStages ? "
                   "2 * kStreamBytes : 0);")
    for load in ("tma_load_4d(q_st + x * kStreamBox, ",
                 "tma_load_4d(g_st + x * kStreamBox, "):
        src = _replace(src, "          " + load,
                       "          if (i < kDkvStages) " + load)
    return src


def no_exp2(src: str) -> str:
    src = _replace(src, "float p = ex2(fmaf(sacc[i], scale_log2, -lrow[half]));",
                   "float p = sacc[i];")
    return _replace(
        src, "const float p = ex2(fmaf(st[i4], scale_log2, "
        "(e & 1) ? -l2.y : -l2.x));", "const float p = st[i4];")


def two_stage_dkv(src: str) -> str:
    return _replace(src, "constexpr int kDkvStages = 3;",
                    "constexpr int kDkvStages = 2;")


def _move(src: str, block: str, after: str) -> str:
    """Move the text ``block`` to just after the text ``after``."""
    return _replace(_replace(src, block, ""), after, after + block)


def scores_first(src: str) -> str:
    dq_grad = ("      if (j > 0) issue_dq<D>(dqacc, ds_tile, sK + sp * kOwnBytes);\n"
               "      wgmma_commit();\n")
    dq_scores = ("      issue_scores<D>(dpacc, g_rows, sV + s * kOwnBytes);\n"
                 "      wgmma_commit();\n")
    dq_release = ("      wgmma_wait<1>();  // dS_{j-1}·K_{j-1} is done\n"
                  "      fence_regs(dqacc);\n"
                  "      if (j > 0 && ltid == 0) mbar_arrive(bar.kempty(sp));\n")
    src = _replace(_move(src, dq_grad, dq_scores), dq_release, "")
    src = _replace(src, "      wgmma_wait<0>();\n      fence_regs(sacc);",
                   "      wgmma_wait<1>();\n      fence_regs(sacc);")
    src = _replace(src, "      store_tile<128>(dpacc, ds_tile, warp, g, t);",
                   "      wgmma_wait<0>();\n      fence_regs(dqacc);\n"
                   "      if (j > 0 && ltid == 0) mbar_arrive(bar.kempty(sp));\n"
                   "      store_tile<128>(dpacc, ds_tile, warp, g, t);")
    dkv_grad = ("      if (i > 0) {\n"
                "        issue_grad<D>(dvacc, pt_tile, sG + sp * kStreamBytes);\n"
                "        issue_grad<D>(dkacc, dst_tile, sQ + sp * kStreamBytes);\n"
                "      }\n      wgmma_commit();\n")
    dkv_scores = ("      issue_scores_t<D>(dpt, v_rows, sG + s * kStreamBytes);\n"
                  "      wgmma_commit();\n")
    dkv_release = ("      wgmma_wait<1>();  // the products of tile i - 1 are done\n"
                   "      fence_regs(dkacc);\n      fence_regs(dvacc);\n"
                   "      if (i > 0 && ltid == 0) mbar_arrive(bar.empty(sp));\n")
    src = _replace(_move(src, dkv_grad, dkv_scores), dkv_release, "")
    src = _replace(src, "      wgmma_wait<0>();\n      fence_regs(st);",
                   "      wgmma_wait<1>();\n      fence_regs(st);")
    return _replace(src, "      store_tile<64>(st, pt_tile, warp, g, t);",
                    "      wgmma_wait<0>();\n      fence_regs(dkacc);\n"
                    "      fence_regs(dvacc);\n"
                    "      if (i > 0 && ltid == 0) mbar_arrive(bar.empty(sp));\n"
                    "      store_tile<64>(st, pt_tile, warp, g, t);")


def no_turns(src: str) -> str:
    for turn in ("bar_sync(1 + c, 256);", "if (c == 0) bar_arrive(1, 256);",
                 "if (!(c == 1 && j == n_tiles - 1)) bar_arrive(2 - c, 256);",
                 "if (!(c == 1 && i == n_tiles - 1)) bar_arrive(2 - c, 256);"):
        src = _replace(src, turn, "")
    return src


def hoisted_bases(src: str) -> str:
    src = _replace(src, 'asm volatile("" : "+r"(x));', "")
    return _replace(src, 'asm volatile("" : "+l"(x));', "")


VARIANTS = {
    "as built": lambda s: s,
    "no_stream_copies": no_stream_copies,
    "no_exp2": no_exp2,
    "no_stream_copies+no_exp2": lambda s: no_stream_copies(no_exp2(s)),
    "two_stage_dkv": two_stage_dkv,
    "scores_first": scores_first,
    "no_turns": no_turns,
    "hoisted_bases": hoisted_bases,
}


def _use_sources(csrc: str) -> None:
    """Build and load the kernels from ``csrc`` from here on."""
    cuda_build.CSRC = csrc
    cuda_build.BUILD_DIR = os.path.join(csrc, "_build")
    cuda_build._libs.clear()
    attn._fns.clear()


def built_variants(source: str, variants: dict, names):
    """For each name in ``names``, build the kernel ``source`` (a file of
    ``csrc/`` without its ``.cu``) from a temporary copy of ``csrc/`` in
    which that file is edited by ``variants[name]``, and yield the name
    once the wrappers launch that build.  The checkout's sources are in
    use again afterwards."""
    src = open(os.path.join(cuda_build.CSRC, f"{source}.cu")).read()
    saved = (cuda_build.CSRC, cuda_build.BUILD_DIR)
    try:
        with tempfile.TemporaryDirectory(prefix=f"probe_{source}_") as tmp:
            for name in names:
                csrc = os.path.join(tmp, name.replace("+", "_").replace(" ", "_"))
                shutil.copytree(saved[0], csrc)
                with open(os.path.join(csrc, f"{source}.cu"), "w") as f:
                    f.write(variants[name](src))
                _use_sources(csrc)
                cuda_build.build(source)
                yield name
    finally:
        _use_sources(saved[0])
        cuda_build.BUILD_DIR = saved[1]


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn()`` over ``iters`` launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=12800)
    ap.add_argument("--heads", type=int, default=24)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--variants", nargs="+", choices=list(VARIANTS),
                    default=list(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_flash_bwd times the kernels on a CUDA device")
    print(card_line(), flush=True)
    S, H, D = args.seq, args.heads, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn((1, S, H, D), generator=gen, device="cuda")
                  .bfloat16() for _ in range(4))
    out, lse = attn.flash_attention(q, k, v)
    drow = attn._row_dot(g, out)
    bounds = {n: m * H * S * S * D / 989e12 * 1e3 for n, m in (("B2a", 8),
                                                                 ("B2b", 6))}
    for name in built_variants(attn.KERNEL_BWD, VARIANTS, args.variants):
        times = {"B2a": [], "B2b": []}
        for _ in range(args.reps):
            times["B2a"].append(cuda_ms(
                lambda: attn.flash_attention_bwd_dkv(q, k, v, g, lse, drow),
                args.iters))
            times["B2b"].append(cuda_ms(
                lambda: attn.flash_attention_bwd_dq(q, k, v, g, lse, drow),
                args.iters))
        print(f"[probe] S={S} {name}: " + " ".join(
            f"{n} " + " / ".join(f"{t:.4f}" for t in ts) + " ms ("
            + " / ".join(f"{bounds[n] / t:.1%}" for t in ts)
            + " of the bound)" for n, ts in times.items()), flush=True)


if __name__ == "__main__":
    main()
