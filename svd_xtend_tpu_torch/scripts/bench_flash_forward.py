"""Device time of the flash forward kernels at the UNet's shapes, for
comparing builds of csrc/flash_fwd.cuh: run it from each tree in one call.

    python -m svd_xtend_tpu_torch.scripts.bench_flash_forward [--tag NAME]

``flash_attention_fwd`` at the four UNet levels (tokens S, heads) at
batch 28 and 14 without the LSE (generate's CFG pair and cond-only passes)
and at batch 14 with it (the train step), and ``flash_variants`` per mode
at (140, 2560): per launch of a CUDA graph, beside SDPA's device time, with
the max-abs error against the plain version (the forward's LSE too; the
variants on their first 8 heads, nosoftmax on positive inputs). The last
line is a JSON object {shape: device ms}.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa
from svd_xtend_tpu_torch.ops.kernels import flash_variants as fv
from svd_xtend_tpu_torch.scripts import card, graph_ms, require_card

LEVELS = [(2560, 5), (640, 10), (160, 20), (40, 20)]
SCALE = 0.125


def forward(dev, gen, b: int, s: int, h: int, lse: bool) -> tuple[float, float, str]:
    """(kernel device ms, SDPA device ms, error note) at one shape."""
    q, k, v = (torch.randn(b, s, h * 64, device=dev, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    o, l = fa.flash_attention_fwd(q, k, v, h, SCALE, with_lse=lse)
    ref_o, ref_l = fa.flash_attention_fwd_reference(q, k, v, h, SCALE)
    note = f"err {(o.float() - ref_o.float()).abs().max().item():.3g}"
    if lse:
        note += f", LSE err {(l - ref_l).abs().max().item():.3g}"
    heads = lambda a: a.view(b, s, h, 64).transpose(1, 2)
    return (graph_ms(lambda: fa.flash_attention_fwd(q, k, v, h, SCALE, with_lse=lse)),
            graph_ms(lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                            scale=SCALE)), note)


def variant(dev, gen, mode: str, bh: int = 140, s: int = 2560) -> tuple[float, float, str]:
    draw = torch.rand if mode == "nosoftmax" else torch.randn
    q, k = (draw(bh, s, 64, device=dev, generator=gen).to(torch.bfloat16) for _ in range(2))
    v = torch.randn(bh, s, 64, device=dev, generator=gen).to(torch.bfloat16)
    got = fv.flash_variants(q[:8], k[:8], v[:8], scale=SCALE, mode=mode)
    ref = fv.flash_variants_reference(q[:8], k[:8], v[:8], SCALE, mode)
    note = f"err {(got.float() - ref.float()).abs().max().item():.3g}"
    return (graph_ms(lambda: fv.flash_variants(q, k, v, scale=SCALE, mode=mode)),
            graph_ms(lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                            scale=SCALE)), note)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tag", default="", help="prefix of every line (the tree's name)")
    args = parser.parse_args(argv)
    dev = require_card()
    print(card())
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for b, lse in [(28, False), (14, False), (14, True)]:
        for s, h in LEVELS:
            ms, sdpa, note = forward(dev, gen, b, s, h, lse)
            key = f"fwd {(b, s, h)}{' lse' if lse else ''}"
            out[key] = ms
            print(f"{args.tag} {key}: {ms:.4f} ms ({4 * b * h * s * s * 64 / ms / 1e9:.0f} "
                  f"TFLOP/s), SDPA {sdpa:.4f} ms; {note}", flush=True)
    for mode in fv.MODES:
        ms, sdpa, note = variant(dev, gen, mode)
        out[f"variants {mode}"] = ms
        print(f"{args.tag} variants {mode} (140, 2560): {ms:.4f} ms "
              f"({4 * 140 * 2560 ** 2 * 64 / ms / 1e9:.0f} TFLOP/s), SDPA {sdpa:.4f} ms; {note}",
              flush=True)
    print(json.dumps({"tag": args.tag, "device_ms": out}))


if __name__ == "__main__":
    main()
