"""The port's hand-written kernels against their plain PyTorch versions on
an NVIDIA GPU, in bf16, at small ragged shapes and at the training sites'
shapes (the full-size run is chip_smoke.py), and the kernels inside
autograd: every kernel's output on inputs that require grad carries a
grad_fn, and its gradients match those of its plain version. Every test is
marked ``cuda`` and skips without a card.

This file imports no jax, so it runs where jax is absent; there, skip the
repository conftest (which sets up jax for the JAX package's tests):

    python -m pytest --noconftest tests/test_torch_port_cuda.py
"""

import math

import pytest
import torch

from svd_xtend_tpu_torch.ops.kernels import conv3x3 as cv
from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa
from svd_xtend_tpu_torch.ops.kernels import geglu as gg
from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn
from svd_xtend_tpu_torch.ops.kernels import temporal_attention as ta
from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr

pytestmark = pytest.mark.cuda


@pytest.fixture
def rn():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA/Triton only")
    g = torch.Generator(device="cuda").manual_seed(0)
    return lambda *s, sc=1.0: (torch.randn(*s, device="cuda", generator=g) * sc
                               ).to(torch.bfloat16)


def _assert_close_bf16(got, ref):
    """Within 4 bf16 ulps of the output's scale: kernel and plain version
    round the same products at different points."""
    torch.cuda.synchronize()
    scale = ref.float().abs().max().item()
    bound = 4.0 * 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)
    assert bool(torch.isfinite(got).all())
    assert (got.float() - ref.float()).abs().max().item() <= bound


@pytest.mark.parametrize("s,t", [(200, 136), (64, 64), (40, 40)])
def test_flash_attention_kernel(rn, s, t):
    q, k, v = rn(2, s, 128), rn(2, t, 128), rn(2, t, 128)
    n = fa.flash_attention_packed.launches
    got = fa.flash_attention_packed(q, k, v, num_heads=2, scale=0.125)
    assert fa.flash_attention_packed.launches == n + 1
    _assert_close_bf16(got, fa.flash_attention_packed_reference(q, k, v, num_heads=2,
                                                                scale=0.125))


@pytest.mark.parametrize("f", [1, 3, 14, 32])
def test_frame_attention_kernel(rn, f):
    q, k, v = rn(2, f, 50, 128), rn(2, f, 50, 128), rn(2, f, 50, 128)
    got = ta.frame_attention(q, k, v, num_heads=2, scale=0.125)
    _assert_close_bf16(got, ta.frame_attention_reference(q, k, v, num_heads=2, scale=0.125))


@pytest.mark.parametrize("f,s,c", [(3, 50, 128), (1, 7, 64), (14, 40, 320)])
def test_temporal_resnet_kernels(rn, f, s, c):
    args = [rn(2, f, s, c), rn(2, f, c), rn(3, c, c, sc=(3 * c) ** -0.5), rn(c, sc=0.1),
            rn(3, c, c, sc=(3 * c) ** -0.5), rn(c, sc=0.1), 1 + 0.1 * rn(c).float(),
            0.1 * rn(c).float(), 1 + 0.1 * rn(c).float(), 0.1 * rn(c).float(),
            torch.tensor(0.37, device="cuda")]
    got = tr.temporal_resnet_block(*args, groups=32, eps=1e-5)
    _assert_close_bf16(got, tr.temporal_resnet_reference(*args, 32, 1e-5))


@pytest.mark.parametrize("shape,silu", [((3, 7, 9, 64), True), ((2, 100, 320), False)])
def test_group_norm_kernel(rn, shape, silu):
    x = rn(*shape) * 3 + 1
    c = shape[-1]
    w, b = 1 + 0.1 * rn(c).float(), 0.1 * rn(c).float()
    got = gn.group_norm_silu(x, w, b, groups=32, eps=1e-6, silu=silu)
    _assert_close_bf16(got, gn.group_norm_silu_reference(x, w, b, 32, 1e-6, silu))


def test_wrappers_raise_on_untaken_shapes(rn):
    with pytest.raises(ValueError):
        tr.temporal_resnet_block(rn(1, 2, 5, 96), rn(1, 2, 96), rn(3, 96, 96), rn(96),
                                 rn(3, 96, 96), rn(96), rn(96), rn(96), rn(96), rn(96),
                                 torch.tensor(0.5, device="cuda"))
    with pytest.raises(ValueError):
        fa.flash_attention_packed(rn(1, 8, 96), rn(1, 8, 96), rn(1, 8, 96), num_heads=2,
                                  scale=0.1)
    with pytest.raises(ValueError):
        ta.frame_attention(*(rn(1, 33, 4, 64) for _ in range(3)), num_heads=1, scale=0.1)


# ------------------------------------------------- kernels inside autograd --

def _grads(fn, inputs, dout):
    leaves = [x.detach().requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    assert out.grad_fn is not None
    return out, torch.autograd.grad(out, leaves, dout)


def _geglu_args(rn, t, c):
    return [rn(t, c), 1 + 0.1 * rn(c), 0.1 * rn(c), rn(8 * c, c, sc=c ** -0.5),
            0.1 * rn(8 * c), rn(c, 4 * c, sc=(4 * c) ** -0.5), 0.1 * rn(c)]


def _tresnet_args(rn, f, s, c):
    return [rn(2, f, s, c), rn(2, f, c), rn(3, c, c, sc=(3 * c) ** -0.5), rn(c, sc=0.1),
            rn(3, c, c, sc=(3 * c) ** -0.5), rn(c, sc=0.1), 1 + 0.1 * rn(c), 0.1 * rn(c),
            1 + 0.1 * rn(c), 0.1 * rn(c), torch.tensor(0.37, device="cuda")]


def _kernel_cases(rn):
    """(name, kernel call, plain call, inputs) of every kernel Function whose
    backward is its plain version's."""
    return [
        ("frame_attention",
         lambda q, k, v: ta.frame_attention(q, k, v, num_heads=2, scale=0.125),
         lambda q, k, v: ta.frame_attention_reference(q, k, v, num_heads=2, scale=0.125),
         [rn(2, 14, 40, 128) for _ in range(3)]),
        ("temporal_resnet_block",
         lambda *a: tr.temporal_resnet_block(*a, groups=32, eps=1e-5),
         lambda *a: tr.temporal_resnet_reference(*a, 32, 1e-5),
         _tresnet_args(rn, 14, 40, 320)),
        ("group_norm_silu",
         lambda x, w, b: gn.group_norm_silu(x, w, b, groups=32, eps=1e-6, silu=True),
         lambda x, w, b: gn.group_norm_silu_reference(x, w, b, 32, 1e-6, True),
         [rn(4, 40, 64, 320) * 3 + 1, 1 + 0.1 * rn(320), 0.1 * rn(320)]),
        ("ln_geglu_residual", gg.ln_geglu_residual, gg.ln_geglu_residual_reference,
         _geglu_args(rn, 300, 320)),
    ]


@pytest.mark.parametrize("case", range(4))
def test_kernel_function_gradients_match_plain(rn, case):
    """Forward through the kernel, backward through the plain version: the
    gradients equal autograd's of the plain version on the same inputs (the
    same recompute, so the bound is the bf16 one of the forward)."""
    name, kernel, plain, inputs = _kernel_cases(rn)[case]
    ref_out = plain(*inputs)
    dout = torch.randn(ref_out.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(1)).to(ref_out.dtype)
    out, got = _grads(kernel, inputs, dout)
    _, ref = _grads(plain, inputs, dout)
    _assert_close_bf16(out, ref_out)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g is not None and g.shape == inputs[i].shape, (name, i)
        _assert_close_bf16(g, r)


def _flash_grad_errors(rn, b, s, heads):
    """Max-abs error against the f32 plain gradient of (the kernels' dq, dk,
    dv) and (the bf16 plain version's), per input."""
    q, k, v = (rn(b, s, heads * 64) for _ in range(3))
    do = rn(b, s, heads * 64)
    run = lambda q, k, v: fa.flash_attention_packed(q, k, v, num_heads=heads, scale=0.125)
    plain = lambda q, k, v: fa.flash_attention_packed_reference(q, k, v, num_heads=heads,
                                                                scale=0.125)
    _, got = _grads(run, (q, k, v), do)
    _, bf = _grads(plain, (q, k, v), do)
    _, f32 = _grads(plain, (q.float(), k.float(), v.float()), do.float())
    torch.cuda.synchronize()
    err = lambda a, r: (a.float() - r).abs().max().item()
    return [(err(g, r), err(p, r), bool(torch.isfinite(g).all()))
            for g, p, r in zip(got, bf, f32)]


@pytest.mark.parametrize("b,s,heads", [(3, 40, 2), (2, 160, 2), (1, 2560, 1)])
def test_flash_backward_kernels_against_plain(rn, b, s, heads):
    """dQ/dK/dV of the kernels at ragged (40, 160) and full (2560) lengths:
    the kernels' error against the f32 plain gradient is finite and at most
    1.5x the bf16 plain version's."""
    n_dq, n_dkv = fa.flash_attention_bwd_dq.launches, fa.flash_attention_bwd_dkv.launches
    for kernel_err, plain_err, finite in _flash_grad_errors(rn, b, s, heads):
        assert finite and kernel_err <= 1.5 * plain_err, (kernel_err, plain_err)
    assert fa.flash_attention_bwd_dq.launches == n_dq + 1
    assert fa.flash_attention_bwd_dkv.launches == n_dkv + 1


@pytest.mark.parametrize("s", [40, 160, 2560])
def test_flash_forward_lse(rn, s):
    q, k, v = rn(2, s, 128), rn(2, s, 128), rn(2, s, 128)
    o, lse = fa.flash_attention_fwd(q, k, v, 2, 0.125)
    ref_o, ref_lse = fa.flash_attention_fwd_reference(q, k, v, 2, 0.125)
    _assert_close_bf16(o, ref_o)
    assert lse.shape == (2, 2, s) and lse.dtype == torch.float32
    # f32 log-sum-exp of the same f32 scores, summed in another order
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("t,c", [(35840, 320), (8960, 640), (2240, 1280), (560, 1280),
                                 (100, 320), (37, 64)])
def test_geglu_kernel(rn, t, c):
    """The four UNet sites at training batch 1 (T x C), and a ragged T."""
    args = _geglu_args(rn, t, c)
    n = gg.ln_geglu_residual.launches
    got = gg.ln_geglu_residual(*args)
    assert gg.ln_geglu_residual.launches == n + 1
    _assert_close_bf16(got - args[0], gg.ln_geglu_residual_reference(*args) - args[0])
    _assert_close_bf16(got, gg.ln_geglu_residual_reference(*args))


def test_geglu_wrapper_raises_on_untaken_shapes(rn):
    with pytest.raises(ValueError):
        gg.ln_geglu_residual(*_geglu_args(rn, 10, 96))


# ------------------------------------------------------------------ conv3x3 --

@pytest.fixture
def no_tf32(monkeypatch):
    """The plain versions' f32 convs in full f32 (cuDNN defaults to TF32)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _conv_args(rn, n, h, w, ci, co, pre, silu, post, res):
    x = rn(n, h, w, ci) * 2 + 0.5
    weight = rn(co, ci, 3, 3, sc=(9 * ci) ** -0.5)
    kw = dict(pre_silu=silu)
    if pre:
        kw.update(pre_scale=(1 + 0.2 * rn(n, ci)).float() / 2, pre_shift=0.3 * rn(n, ci).float())
    if post:
        kw["post_shift"] = 0.5 * rn(n, co).float()
    if res:
        kw["residual"] = rn(n, h, w, co)
    return x, weight, 0.1 * rn(co), kw


# (pre, silu, post, res): none, pre, preS, preS+post, preS+res, post+res
_EPILOGUES = [(False, False, False, False), (True, False, False, False),
              (True, True, False, False), (True, True, True, False),
              (True, True, False, True), (False, False, True, True)]


@pytest.mark.parametrize("epi", range(6))
@pytest.mark.parametrize("shape", [(14, 40, 64, 320, 320), (2, 10, 16, 640, 1280),
                                   (4, 5, 8, 2560, 1280), (100, 9, 13, 64, 320),
                                   (2, 9, 5, 8, 40), (14, 40, 64, 8, 320)])
def test_conv3x3_kernel(rn, no_tf32, shape, epi):
    """With each epilogue: the UNet's L0 resnet shape at training batch (128
    wide column tiles, the third masked at Co 320), its L2 and L3 shapes
    (64-wide tiles), a W that is not a multiple of 64 with Co 320 and enough
    pixels for 128-wide tiles, and Ci 8 (not a multiple of the 32-channel K
    tile) with a ragged 64-wide tile (Co 40) and at the conv_in width on
    128-wide tiles."""
    x, weight, bias, kw = _conv_args(rn, *shape, *_EPILOGUES[epi])
    n = cv.conv3x3.launches
    got = cv.conv3x3(x, weight, bias, **kw)
    assert cv.conv3x3.launches == n + 1
    ref = cv.conv3x3_fused_reference(x, weight, bias, kw.get("pre_scale"), kw.get("pre_shift"),
                                     kw.get("post_shift"), kw.get("residual"), kw["pre_silu"])
    _assert_close_bf16(got, ref)


@pytest.mark.parametrize("shape", [(2, 20, 32, 64, 128), (3, 5, 8, 320, 640)])
def test_conv3x3_gradients_against_plain(rn, no_tf32, shape):
    """The Function's gradients (dU through the kernel, dW through cuDNN)
    against the f32 plain gradient: finite, and each at most 1.5x the max-abs
    error of the bf16 plain version's gradient on the same inputs."""
    x, weight, bias, kw = _conv_args(rn, *shape, True, True, True, True)
    names = ("pre_scale", "pre_shift", "post_shift", "residual")
    inputs = [x, weight, bias] + [kw[a] for a in names]
    run = lambda x, w, b, sc, sh, post, res: cv.conv3x3(
        x, w, b, pre_scale=sc, pre_shift=sh, pre_silu=True, post_shift=post, residual=res)
    plain = lambda *a: cv.conv3x3_fused_reference(*a, True)
    dy = rn(*shape[:3], shape[4])
    n = cv.conv3x3_input_grad.launches
    _, got = _grads(run, inputs, dy)
    assert cv.conv3x3_input_grad.launches == n + 1
    _, bf = _grads(plain, inputs, dy)
    _, f32 = _grads(plain, [a.float() for a in inputs], dy.float())
    torch.cuda.synchronize()
    for i, (g, p, r) in enumerate(zip(got, bf, f32)):
        err, perr = ((a.float() - r).abs().max().item() for a in (g, p))
        assert bool(torch.isfinite(g).all()) and err <= 1.5 * perr, (i, err, perr)


def test_conv3x3_wrapper_raises_on_untaken_calls(rn):
    with pytest.raises(ValueError):                 # Ci 12: not a multiple of 8
        cv.conv3x3(rn(1, 4, 4, 12), rn(16, 12, 3, 3), rn(16))
    with pytest.raises(ValueError):                 # f32 activations
        cv.conv3x3(rn(1, 4, 4, 16).float(), rn(16, 16, 3, 3), rn(16))
    with pytest.raises(ValueError):                 # residual of the wrong width
        cv.conv3x3(rn(1, 4, 4, 16), rn(16, 16, 3, 3), rn(16), residual=rn(1, 4, 4, 8))


@pytest.mark.parametrize("s", [40, 2560])
def test_flash_attention_bshd_kernel(rn, s):
    """The head-major entry point on (B, S, H, 64): the forward kernel on the
    same memory, and its gradients through the dQ and dK/dV kernels."""
    q, k, v = (rn(2, s, 2, 64) for _ in range(3))
    plain = lambda q, k, v: fa.flash_attention_packed_reference(
        q.flatten(2), k.flatten(2), v.flatten(2), num_heads=2, scale=0.125).reshape(q.shape)
    n = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, scale=0.125)
    assert fa.flash_attention.launches == n + 1 and got.shape == q.shape
    _assert_close_bf16(got, plain(q, k, v))
    do = rn(2, s, 2, 64)
    _, g = _grads(lambda q, k, v: fa.flash_attention(q, k, v, scale=0.125), (q, k, v), do)
    _, bf = _grads(plain, (q, k, v), do)
    _, f32 = _grads(plain, (q.float(), k.float(), v.float()), do.float())
    for a, p, r in zip(g, bf, f32):
        err, perr = ((x.float() - r).abs().max().item() for x in (a, p))
        assert err <= 1.5 * perr, (err, perr)
