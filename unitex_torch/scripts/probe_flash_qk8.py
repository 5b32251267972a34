"""What bounds kernel B3 on the card: it is timed as built, and again built
from copies of ``csrc/flash_attn_qk8.cu`` with one cost taken out or one
design choice undone, beside B1 on the same q/k/v.

    python -m unitex_torch.scripts.probe_flash_qk8 [--seq 13824] [--heads 24]

Costs taken out (timing only: the output is wrong by construction):

- ``no_stream_copies``: after the ring's first fill the producer thread
  arrives on each stage's full barriers without copying K and V, so the
  consumers run on stale tiles with no TMA traffic (the key scales are
  still copied);
- ``no_exp2``: P is the shifted logit instead of its exp2;
- both;
- ``no_key_scales``: the logits are not multiplied by the key scales, and
  the consumers do not read them.

Ring depths: ``two_stages`` and ``four_stages`` (built: 3).  Design
choices, each undone in one variant (right output for positive row
scales, as ``quant_rows`` makes them): ``no_turns`` (no named-barrier
turns between the consumers), ``row_scale_per_logit`` (the row factor
multiplied into every logit instead of into the tile's max and the exp2's
multiply-add), ``mask_every_tile`` (the test for keys past S in every
tile, not only the last) and ``integer_add_conversion`` (the s32 logits
converted to f32 by adding 1.5·2^23 to their bits and subtracting it as a
float, on the FMA pipe, instead of by I2FP).  Each variant is built with
nvcc from a temporary copy of ``csrc/``; the card's name and power limit
head the output.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import attention as attn
from .probe_flash_bwd import built_variants, card_line, cuda_ms


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"flash_attn_qk8.cu no longer holds {old!r}")
    return src.replace(old, new)


def no_stream_copies(src: str) -> str:
    src = _replace(src, "mbar_expect_tx(bar.kfull(s), kKBytes);",
                   "mbar_expect_tx(bar.kfull(s), j < kStages ? kKBytes : 0);")
    src = _replace(src, "mbar_expect_tx(bar.vfull(s), kVBytes);",
                   "mbar_expect_tx(bar.vfull(s), j < kStages ? kVBytes : 0);")
    for load in ("tma_load_4d(sK + s * kKBytes, ", "tma_load_4d(sV + s * kVBytes, ",
                 "tma_load_4d(sV + s * kVBytes + kVBox, "):
        src = _replace(src, "        " + load, "        if (j < kStages) " + load)
    return src


def no_exp2(src: str) -> str:
    src = _replace(src, "s[i] = ex2(fmaf(s[i], a, -m_new));",
                   "s[i] = fmaf(s[i], a, -m_new);")
    return _replace(src, "s[i + 1] = ex2(fmaf(s[i + 1], a, -m_new));",
                    "s[i + 1] = fmaf(s[i + 1], a, -m_new);")


_LOGIT = """      s[4 * nt + e] =
          static_cast<float>(acc[4 * nt + e]) * ((e & 1) ? skv.y : skv.x);"""


def no_key_scales(src: str) -> str:
    src = _replace(src, """    const float2 skv =
        *reinterpret_cast<const float2*>(sk_tile + nt * 8 + 2 * t);
""", "")
    return _replace(src, _LOGIT,
                    "      s[4 * nt + e] = static_cast<float>(acc[4 * nt + e]);")


def stages(n: int):
    return lambda src: _replace(src, "constexpr int kStages = 3;",
                                f"constexpr int kStages = {n};")


def no_turns(src: str) -> str:
    for turn in ("bar_sync(1 + c, 256);", "if (c == 0) bar_arrive(1, 256);",
                 "if (!(c == 1 && n_tiles == 1)) bar_arrive(2 - c, 256);",
                 "if (!(c == 1 && j == n_tiles - 1)) bar_arrive(2 - c, 256);"):
        src = _replace(src, turn, "")
    return src


def row_scale_per_logit(src: str) -> str:
    src = _replace(src, _LOGIT, """      s[4 * nt + e] = static_cast<float>(acc[4 * nt + e]) * rowf[e >> 1] *
                      ((e & 1) ? skv.y : skv.x);""")
    return _replace(src, "const float a = rowf[half];", "const float a = 1.f;")


def mask_every_tile(src: str) -> str:
    return _replace(src, "dequant<decltype(last)::value>(", "dequant<true>(")


def integer_add_conversion(src: str) -> str:
    return _replace(src, "static_cast<float>(acc[4 * nt + e]) * ((e & 1)",
                    "(__int_as_float(acc[4 * nt + e] + 0x4B400000) - 12582912.f) *"
                    " ((e & 1)")


VARIANTS = {
    "as built": lambda s: s,
    "no_stream_copies": no_stream_copies,
    "no_exp2": no_exp2,
    "no_stream_copies+no_exp2": lambda s: no_stream_copies(no_exp2(s)),
    "no_key_scales": no_key_scales,
    "two_stages": stages(2),
    "four_stages": stages(4),
    "no_turns": no_turns,
    "row_scale_per_logit": row_scale_per_logit,
    "mask_every_tile": mask_every_tile,
    "integer_add_conversion": integer_add_conversion,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=13824)
    ap.add_argument("--heads", type=int, default=24)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variants", nargs="+", choices=list(VARIANTS),
                    default=list(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_flash_qk8 times the kernels on a CUDA device")
    print(card_line(), flush=True)
    S, H, D = args.seq, args.heads, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((1, S, H, D), generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    qq, sq = attn.quant_rows(q)
    kq, sk = attn.quant_rows(k)
    ops = 2 * H * S * S * D
    bound = (ops / 1979e12 + ops / 989e12) * 1e3
    heads = (0, H - 1)   # the f32 reference of two heads, for the error
    ref = [attn.attention_qk8_reference(*(x[:, :, h:h + 1] for x in (
        qq, kq, v.float(), sq, sk))) for h in heads]

    def b1_line(when):
        ts = [cuda_ms(lambda: attn.flash_attention(q, k, v), args.iters)
              for _ in range(args.reps)]
        print(f"[probe] S={S} B1 as built ({when}): "
              + " / ".join(f"{t:.4f}" for t in ts) + " ms", flush=True)

    b1_line("first")
    for name in built_variants(attn.KERNEL_QK8, VARIANTS, args.variants):
        out = attn.flash_attention_qk8(qq, kq, v, sq, sk)
        err = max((out[:, :, h:h + 1].float() - r).abs().max().item()
                  for h, r in zip(heads, ref))
        ts = [cuda_ms(lambda: attn.flash_attention_qk8(qq, kq, v, sq, sk),
                      args.iters) for _ in range(args.reps)]
        print(f"[probe] S={S} B3 {name}: " + " / ".join(f"{t:.4f}" for t in ts)
              + " ms (" + " / ".join(f"{bound / t:.1%}" for t in ts)
              + f" of the bound); max|dout| in heads {heads} {err:.3e}",
              flush=True)
    b1_line("last")


if __name__ == "__main__":
    main()
