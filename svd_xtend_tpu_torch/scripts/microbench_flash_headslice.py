"""Probe: the flash forward on the projections' packed (B, S, H*64) layout
against the head-major (B, S, H, 64) entry point, at the UNet's L0 and L1
self-attention shapes (CFG batch 2x14 frames).

Counterpart of ``scripts/microbench_flash_headslice.py``:

  arm T: ``flash_attention`` on (B, S, H, 64) (on the TPU: transposes around
         a (B*H, S, 64) kernel; here the same memory as the packed layout);
  arm H: ``flash_attention_packed`` (heads sliced in place);
  arm HS: ``flash_attention_headsliced``, the port of the probe's own
         ``_fwd_headsliced`` (grid over batch, head, query tile; out + LSE).

    python -m svd_xtend_tpu_torch.scripts.microbench_flash_headslice
"""

from __future__ import annotations

import torch

from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa
from svd_xtend_tpu_torch.scripts import card, cuda_ms, require_card

SHAPES = [(28, 2560, 5), (28, 640, 10)]
D = 64


def arms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int):
    """name -> call of each arm on packed (B, S, H*64) q, k, v."""
    b, s, _ = q.shape
    scale = D ** -0.5
    r = lambda x: x.view(b, s, num_heads, D)
    return {
        "T": lambda: fa.flash_attention(r(q), r(k), r(v), scale=scale).view(b, s, -1),
        "H": lambda: fa.flash_attention_packed(q, k, v, num_heads=num_heads, scale=scale),
        "HS": lambda: fa.flash_attention_headsliced(q, k, v, scale=scale,
                                                   num_heads=num_heads)[0],
    }


def run(b: int, s: int, h: int, seed: int = 0, iters: int = 10) -> dict:
    """Each arm's ms and its max |diff| against arm H, at one shape."""
    dev = require_card()
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, s, h * D, device=dev, generator=g).to(torch.bfloat16)
               for _ in range(3))
    calls = arms(q, k, v, h)
    o_h = calls["H"]().float()
    res = {}
    for name, fn in calls.items():
        res[name] = dict(ms=cuda_ms(fn, iters), err=(fn().float() - o_h).abs().max().item())
    return res


def main() -> None:
    print(card())
    for b, s, h in SHAPES:
        res = run(b, s, h)
        flops = 4 * b * h * s * s * D
        t, hs = res["T"]["ms"], res["HS"]["ms"]
        print(f"(b={b},s={s},h={h}): transpose-form {t:7.3f} ms | head-sliced "
              f"{res['H']['ms']:7.3f} ms ({t / res['H']['ms']:.3f}x)  "
              f"max|diff|={res['T']['err']:.2e} | headsliced+LSE {hs:7.3f} ms "
              f"({flops / hs / 1e9:.1f} TFLOP/s) max|diff|={res['HS']['err']:.2e}",
              flush=True)


if __name__ == "__main__":
    main()
