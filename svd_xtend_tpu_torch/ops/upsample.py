"""Nearest 2x upsample + 3x3 conv by the parity decomposition.

Port of ``svd_xtend_tpu/ops/upsample.py``, the form the JAX package's
Upsample2D runs by default. With X_up[p, q] = x[p // 2, q // 2], the output
at parity (di, dj) is

    y[2i+di, 2j+dj] = sum_{u,v in {-1,0,1}} K[u, v] · X_up[2i+di+u, 2j+dj+v]

and the floor division collapses each 3-tap axis to 2 taps:

    rows, di = 0: row i-1 takes K[0],         row i   takes K[1] + K[2]
    rows, di = 1: row i   takes K[0] + K[1],  row i+1 takes K[2]

(columns the same). So the op is four 2x2 convs at the input resolution on
tap-summed kernels, interleaved: 16 taps an output pixel instead of 36 for
the conv of the upsampled tensor, and no 4x intermediate. The SAME padding
of the upsampled image maps onto each parity conv's zero padding, so the
result equals ``conv3x3(nearest_upsample_2x(x))`` in exact arithmetic.

The hand kernel that runs this on the card is ``ops/kernels/upsample_conv.py``
(csrc/upsample_conv.cu); the plain version here is what it is held to, and
what the models run on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import video


def tap_sums(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The four parity kernels (4, Co, 2, 2, Ci), parity p = 2·di + dj, from
    the OIHW (Co, Ci, 3, 3) weight: cast to the activation dtype first, then
    summed (rows, then columns) in it, as JAX does (upsample.py:62-72), so
    that the bf16 forms agree."""
    k = weight.to(dtype)
    rows = (torch.stack([k[:, :, 0], k[:, :, 1] + k[:, :, 2]], dim=2),
            torch.stack([k[:, :, 0] + k[:, :, 1], k[:, :, 2]], dim=2))   # (Co, Ci, 2, 3)
    out = []
    for r in rows:
        out += [torch.stack([r[..., 0], r[..., 1] + r[..., 2]], dim=3),
                torch.stack([r[..., 0] + r[..., 1], r[..., 2]], dim=3)]  # (Co, Ci, 2, 2)
    return torch.stack(out).permute(0, 1, 3, 4, 2)


def upsample2x_conv3x3_reference(x: torch.Tensor, weight: torch.Tensor,
                                 bias: torch.Tensor) -> torch.Tensor:
    """(N, H, W, Ci), OIHW (Co, Ci, 3, 3), (Co,) -> (N, 2H, 2W, Co), equal to
    the 3x3 SAME conv of x upsampled 2x (nearest). Each parity is a 2x2 conv
    with JAX's paddings (``_conv2x2``: top/left for parity 0, bottom/right
    for parity 1), in f32 over x-dtype values and rounded to x's dtype; the
    bias, cast to x's dtype, is added after that rounding (upsample.py:77-79);
    the parities are interleaved by a stack and a reshape."""
    n, h, w, _ = x.shape
    dt = x.dtype
    kk = tap_sums(weight, dt)
    b = bias.to(dt)
    xc = video.nchw(x).float()
    ys = []
    for di in (0, 1):
        row = []
        for dj in (0, 1):
            k = kk[2 * di + dj].permute(0, 3, 1, 2).float()          # OIHW (Co, Ci, 2, 2)
            y = F.conv2d(F.pad(xc, (1 - dj, dj, 1 - di, di)), k).to(dt)
            row.append(video.nhwc(y) + b)
        ys.append(torch.stack(row, dim=3))                           # (N, H, W, 2, Co)
    return torch.stack(ys, dim=2).reshape(n, 2 * h, 2 * w, kk.shape[1])
