"""Operations and bytes of Stable Video Diffusion's work, from its published
config and the shapes of a call.

Counting convention (that of ``torch.utils.flop_counter.FlopCounterMode``,
which the tests hold these functions to on the reference): 2 operations per
multiply-accumulate of every matrix product and convolution, the published
math as diffusers defines it (the upsampler's nearest 2x then 3x3 conv at the
output resolution, the up blocks' conv over the concatenated skip, the CLIP
resize's two matrix products), nothing for elementwise work, norms, softmax
and sampling. A cross-attention over SVD's single context token counts
to_v and to_out over that token alone: softmax over one key is 1, so q and k
take no part in the result. Attention counts QK^T and PV,
4 · batch · heads · L · S · head_dim.

Bytes, for a roofline: every input read once (activations and weights, bf16:
2 bytes a value) and every output written once.

The training step (``train_step_flops``): the forward, the backward's
activation gradients, and the weight gradients of the trainable leaves
alone, as autograd computes them (the tests hold the count to
FlopCounterMode's over the reference's step). A product contributes its
forward count once more for the gradient of its activation operand, twice
for attention's two activation operands, not at all where the input is the
time or context embedding; every product of the UNet after the first
trainable layer, in execution order, counts (the up blocks' convs over
their whole concatenated input). Remat's recompute is not counted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

BF16 = 2


@dataclass
class Op:
    """One product: its forward operations, how many of its operands are
    activations whose gradient the backward needs (1 for a linear or conv on
    the activations, 2 for attention's products, 0 where the input is the
    time or context embedding, which no gradient reaches), and whether its
    weight is trained."""

    flops: float
    acts: int = 1
    trainable: bool = False


def linear(rows, i, o, **kw) -> Op:
    return Op(2.0 * rows * i * o, **kw)


def conv(pixels, i, o, k, **kw) -> Op:
    """`pixels`: output positions (N·H·W, or N·F·H·W for a frame conv);
    `k`: the kernel's taps (9 for 3x3, 3 for (3, 1, 1), 1 for 1x1)."""
    return Op(2.0 * pixels * i * o * k, **kw)


def attention(batch, heads, lq, lk, head_dim, **kw) -> Op:
    return Op(4.0 * batch * heads * lq * lk * head_dim, acts=2, **kw)


def _layers(value, n: int) -> List[int]:
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


def _st_resblock(ops, n, hw, cin, cout, temb, trainable=False):
    """SpatioTemporalResBlock on N = B·F frames of hw positions."""
    ops.append(conv(n * hw, cin, cout, 9))
    if temb:
        ops.append(linear(n, temb, cout, acts=0))
    ops.append(conv(n * hw, cout, cout, 9))
    if cin != cout:
        ops.append(conv(n * hw, cin, cout, 1))
    if temb:
        ops.append(linear(n, temb, cout, acts=0))
    ops.append(conv(n * hw, cout, cout, 3))
    ops.append(conv(n * hw, cout, cout, 3))


def attn1_ops(n, s, c, heads, **kw) -> List[Op]:
    """A self-attention module over N sequences of S tokens of width C."""
    return [linear(n * s, c, c, **kw) for _ in range(3)] + [
        attention(n, heads, s, s, c // heads, **kw), linear(n * s, c, c, **kw)]


def ff_ops(rows, c, **kw) -> List[Op]:
    """The GEGLU feed-forward (C -> 2·4C, gate, 4C -> C) over `rows` tokens."""
    return [linear(rows, c, 8 * c, **kw), linear(rows, 4 * c, c, **kw)]


def _transformer(ops, b, f, hw, c, heads, ctx, layers):
    n = b * f
    ops.append(linear(n * hw, c, c))
    ops.append(linear(f, c, 4 * c, acts=0))
    ops.append(linear(f, 4 * c, c, acts=0))
    for _ in range(layers):
        ops.extend(attn1_ops(n, hw, c, heads))
        ops.extend([linear(n, ctx, c, acts=0),
                    linear(n, c, c, acts=0)])
        ops.extend(ff_ops(n * hw, c))
        t = dict(trainable=True)
        ops.extend(ff_ops(n * hw, c, **t))
        ops.extend(attn1_ops(b * hw, f, c, heads, **t))
        ops.extend([linear(b, ctx, c, acts=0, **t), linear(b, c, c, **t)])
        ops.extend(ff_ops(n * hw, c, **t))
    ops.append(linear(n * hw, c, c))


def unet_ops(cfg: dict, b: int, f: int, h: int, w: int) -> List[Op]:
    """The UNet forward on B samples of F frames at an h x w latent, in
    execution order."""
    chs = list(cfg["block_out_channels"])
    n_lv = len(chs)
    heads = _layers(cfg["num_attention_heads"], n_lv)
    tl = _layers(cfg["transformer_layers_per_block"], n_lv)
    ctx, lpb = cfg["cross_attention_dim"], cfg["layers_per_block"]
    tdim = 4 * chs[0]
    n = b * f
    ops = [linear(b, chs[0], tdim), linear(b, tdim, tdim),
           linear(b, cfg["projection_class_embeddings_input_dim"], tdim),
           linear(b, tdim, tdim), conv(n * h * w, cfg["in_channels"], chs[0], 9)]
    hh, ww, cin = h, w, chs[0]
    for i, kind in enumerate(cfg["down_block_types"]):
        for j in range(lpb):
            _st_resblock(ops, n, hh * ww, cin if j == 0 else chs[i], chs[i], tdim)
            if kind.startswith("CrossAttn"):
                _transformer(ops, b, f, hh * ww, chs[i], heads[i], ctx, tl[i])
        cin = chs[i]
        if i < n_lv - 1:
            hh, ww = (hh + 1) // 2, (ww + 1) // 2
            ops.append(conv(n * hh * ww, chs[i], chs[i], 9))
    _st_resblock(ops, n, hh * ww, chs[-1], chs[-1], tdim)
    _transformer(ops, b, f, hh * ww, chs[-1], heads[-1], ctx, tl[-1])
    _st_resblock(ops, n, hh * ww, chs[-1], chs[-1], tdim)
    rev = chs[::-1]
    prev = rev[0]
    for i, kind in enumerate(cfg["up_block_types"]):
        skip = [rev[i]] * lpb + [rev[min(i + 1, n_lv - 1)]]
        for j, sc in enumerate(skip):
            _st_resblock(ops, n, hh * ww, (prev if j == 0 else rev[i]) + sc, rev[i], tdim)
            if kind.startswith("CrossAttn"):
                _transformer(ops, b, f, hh * ww, rev[i], heads[n_lv - 1 - i], ctx,
                             tl[n_lv - 1 - i])
        prev = rev[i]
        if i < n_lv - 1:
            hh, ww = 2 * hh, 2 * ww
            ops.append(conv(n * hh * ww, rev[i], rev[i], 9))
    ops.append(conv(n * h * w, chs[0], cfg["out_channels"], 9))
    return ops


def unet_flops(cfg: dict, b: int, f: int, h: int, w: int) -> float:
    return sum(op.flops for op in unet_ops(cfg, b, f, h, w))


def _vae_attention(n, s, c):
    return [linear(n * s, c, c) for _ in range(3)] + [attention(n, max(1, c // 512), s, s,
                                                                 c // max(1, c // 512)),
                                                       linear(n * s, c, c)]


def vae_encode_flops(cfg: dict, n: int, h: int, w: int) -> float:
    """The encoder and quant_conv on N images of h x w pixels."""
    chs, lpb = list(cfg["block_out_channels"]), cfg["layers_per_block"]
    ops = [conv(n * h * w, cfg["in_channels"], chs[0], 9)]
    cin = chs[0]
    for i, ch in enumerate(chs):
        for j in range(lpb):
            c0 = cin if j == 0 else ch
            ops += [conv(n * h * w, c0, ch, 9), conv(n * h * w, ch, ch, 9)]
            if c0 != ch:
                ops.append(conv(n * h * w, c0, ch, 1))
        cin = ch
        if i < len(chs) - 1:
            h, w = h // 2, w // 2
            ops.append(conv(n * h * w, ch, ch, 9))
    c = chs[-1]
    ops += [conv(n * h * w, c, c, 9), conv(n * h * w, c, c, 9)]
    ops += _vae_attention(n, h * w, c)
    ops += [conv(n * h * w, c, c, 9), conv(n * h * w, c, c, 9)]
    lat2 = 2 * cfg["latent_channels"]
    ops += [conv(n * h * w, c, lat2, 9), conv(n * h * w, lat2, lat2, 1)]
    return sum(op.flops for op in ops)


def vae_decode_flops(cfg: dict, n: int, h: int, w: int) -> float:
    """The temporal decoder on N frames of an h x w latent (the frame convs
    per frame, so chunking changes nothing)."""
    chs, lpb = list(cfg["block_out_channels"]), cfg["layers_per_block"]
    top = chs[-1]
    ops = [conv(n * h * w, cfg["latent_channels"], top, 9)]
    _st_resblock(ops, n, h * w, top, top, 0)
    ops += _vae_attention(n, h * w, top)
    _st_resblock(ops, n, h * w, top, top, 0)
    cin = top
    rev = chs[::-1]
    for i, ch in enumerate(rev):
        for j in range(lpb + 1):
            _st_resblock(ops, n, h * w, cin if j == 0 else ch, ch, 0)
        cin = ch
        if i < len(rev) - 1:
            h, w = 2 * h, 2 * w
            ops.append(conv(n * h * w, ch, ch, 9))
    co = cfg["out_channels"]
    ops += [conv(n * h * w, chs[0], co, 9), conv(n * h * w, co, co, 3)]
    return sum(op.flops for op in ops)


def clip_flops(cfg: dict, n: int, h: int, w: int) -> float:
    """The antialiased resize of N h x w images, then the vision tower with
    its projection."""
    s, p, wd = cfg["image_size"], cfg["patch_size"], cfg["hidden_size"]
    resize = 2.0 * s * h * w * 3 * n + 2.0 * s * w * s * 3 * n
    grid = (s // p) ** 2
    t = grid + 1
    ops = [conv(n * grid, cfg["num_channels"], wd, p * p)]
    for _ in range(cfg["num_hidden_layers"]):
        ops += [linear(n * t, wd, wd) for _ in range(3)]
        ops += [attention(n, cfg["num_attention_heads"], t, t, wd // cfg["num_attention_heads"]),
                linear(n * t, wd, wd), linear(n * t, wd, cfg["intermediate_size"]),
                linear(n * t, cfg["intermediate_size"], wd)]
    ops.append(linear(n, wd, cfg["projection_dim"]))
    return resize + sum(op.flops for op in ops)


def latent_shape(cfg: dict, height: int, width: int):
    ds = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    return height // ds, width // ds


def video_flops(cfg: dict, pipe: dict) -> float:
    """One exact video of `pipe` (the traffic's pipeline parameters): CLIP and
    the VAE encode of the image, every CFG pair pass, the decode of every
    frame."""
    h, w = latent_shape(cfg, pipe["height"], pipe["width"])
    f, b = pipe["num_frames"], 1
    return (clip_flops(cfg["image_encoder"], b, pipe["height"], pipe["width"])
            + vae_encode_flops(cfg["vae"], b, pipe["height"], pipe["width"])
            + pipe["num_inference_steps"] * unet_flops(cfg["unet"], 2 * b, f, h, w)
            + vae_decode_flops(cfg["vae"], b * f, h, w))


def backward_flops(ops: Sequence[Op]) -> float:
    """Activation gradients of every product after the first trainable one,
    and the weight gradients of the trainable ones."""
    first = next((i for i, op in enumerate(ops) if op.trainable), len(ops))
    dgrad = sum(op.flops * op.acts for op in ops[first:])
    wgrad = sum(op.flops for op in ops if op.trainable and op.acts < 2)
    return dgrad + wgrad


def train_step_flops(cfg: dict, train: dict) -> float:
    """One step of the 'temporal' scope on a batch of `train` (the traffic's
    TrainConfig fields): the frozen encodes (every frame, the noised first
    frame, CLIP of the first frame), the UNet forward and its backward."""
    b, f = train["per_device_batch_size"], train["num_frames"]
    hp, wp = train["height"], train["width"]
    h, w = latent_shape(cfg, hp, wp)
    ops = unet_ops(cfg["unet"], b, f, h, w)
    return (vae_encode_flops(cfg["vae"], b * f + b, hp, wp)
            + clip_flops(cfg["image_encoder"], b, hp, wp)
            + sum(op.flops for op in ops) + backward_flops(ops))


# -- the two rooflines' modules, per call --

def attn1_cost(n: int, s: int, c: int, heads: int):
    """(operations, bytes) of a spatial self-attention module (q, k, v, out
    projections and the attention) on N sequences of S tokens of width C in
    bf16."""
    flops = sum(op.flops for op in attn1_ops(n, s, c, heads))
    return flops, BF16 * (2 * n * s * c + 4 * c * c + c)


def ff_cost(rows: int, c: int):
    """(operations, bytes) of the feed-forward sublayer x + FF(LN(x)) over
    `rows` tokens of width C in bf16."""
    flops = sum(op.flops for op in ff_ops(rows, c))
    weights = 8 * c * c + 8 * c + 4 * c * c + c + 2 * c
    return flops, BF16 * (2 * rows * c + weights)
