"""The port's conv3x3 (ops/kernels/conv3x3.py), its Conv3x3 module and the
GN-folded ResnetBlock2D against the JAX package, and the head-major flash
entry point (ops/attention.py::dot_product_attention(impl="flash")).

The JAX side runs as its own tests run it on the CPU: ``conv3x3_pallas`` in
interpret mode (W a multiple of 8, ``band=3``), its XLA
``conv3x3_fused_reference``, and ResnetBlock2D at its default (GN fold, XLA
conv) and with ``SVDX_PALLAS_CONV=force`` (the Pallas kernel in interpret
mode). Inputs are float32 from numpy seeds, fed to both packages. The CUDA
kernel itself runs only on a GPU: tests/test_torch_port_cuda.py and
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu.models import blocks as jb
from svd_xtend_tpu.ops.pallas import conv3x3 as jcv
from svd_xtend_tpu.ops.pallas import flash_attention as jfa
from svd_xtend_tpu_torch.io.convert import diffusers_state_dict
from svd_xtend_tpu_torch.models import blocks as tb
from svd_xtend_tpu_torch.ops import attention as tatt
from svd_xtend_tpu_torch.ops.kernels import conv3x3 as tcv

torch.set_num_threads(1)

# the conv alone in f32: only the summation order of the 9*Ci products
# differs (XLA's conv or the Pallas dots vs torch's CPU conv)
CONV_TOL = dict(atol=1e-5, rtol=1e-5)
# gradients and modules: sums over every output position (dW, db, dsc, dsh)
# or two convs and a GroupNorm in sequence, O(1-10) values, f32 reassociation
MODULE_TOL = dict(atol=1e-4, rtol=1e-4)

N, H, W, CI, CO = 2, 6, 8, 48, 32
# (name, pre given, silu, post given, residual given)
EPILOGUES = [("none", False, False, False, False), ("pre", True, False, False, False),
             ("preS", True, True, False, False), ("preS+post", True, True, True, False),
             ("preS+res", True, True, False, True), ("post+res", False, False, True, True)]


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _conv_inputs(seed):
    """x, the JAX HWIO kernel, bias, sc, sh, post, res, dy."""
    rs = np.random.RandomState(seed)
    return (_rand(rs, N, H, W, CI), _rand(rs, 3, 3, CI, CO, scale=0.1),
            _rand(rs, CO, scale=0.1), 1 + _rand(rs, N, CI, scale=0.3),
            _rand(rs, N, CI, scale=0.3), _rand(rs, N, CO, scale=0.2),
            _rand(rs, N, H, W, CO), _rand(rs, N, H, W, CO))


def _oihw(kernel_hwio):
    return np.ascontiguousarray(kernel_hwio.transpose(3, 2, 0, 1))


def _epilogue(case, sc, sh, post, res):
    """The keyword arguments of one epilogue combination."""
    _, pre, silu, has_post, has_res = case
    kw = {}
    if pre:
        kw.update(pre_scale=sc, pre_shift=sh, pre_silu=silu)
    if has_post:
        kw["post_shift"] = post
    if has_res:
        kw["residual"] = res
    return kw


@pytest.mark.parametrize("case", EPILOGUES, ids=[c[0] for c in EPILOGUES])
def test_conv_plain_matches_pallas_kernel(case):
    """conv3x3_fused_reference against the Pallas kernel (interpret mode)
    and the JAX package's XLA reference, for each epilogue combination."""
    x, k, b, sc, sh, post, res, _ = _conv_inputs(1)
    jkw = {a: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for a, v in _epilogue(case, sc, sh, post, res).items()}
    pallas = np.asarray(jcv.conv3x3_pallas(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                           band=3, **jkw))
    ref = np.asarray(jcv.conv3x3_fused_reference(jnp.asarray(x), jnp.asarray(k),
                                                 jnp.asarray(b), **jkw))
    tkw = {a: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for a, v in _epilogue(case, sc, sh, post, res).items()}
    got = tcv.conv3x3(torch.from_numpy(x), torch.from_numpy(_oihw(k)), torch.from_numpy(b),
                      **tkw).numpy()
    np.testing.assert_allclose(got, pallas, **CONV_TOL)
    np.testing.assert_allclose(got, ref, **CONV_TOL)


@pytest.mark.parametrize("case", EPILOGUES, ids=[c[0] for c in EPILOGUES])
def test_conv_function_gradients_match_pallas_vjp(case):
    """The explicit backward of _Conv3x3Function (the plain forward injected
    as the kernel, for the forward and for dU) against jax.grad through
    conv3x3_pallas's custom VJP: x, weight, bias and each epilogue input."""
    x, k, b, sc, sh, post, res, dy = _conv_inputs(2)
    kw = _epilogue(case, sc, sh, post, res)
    names = [a for a in ("pre_scale", "pre_shift", "post_shift", "residual") if a in kw]
    silu = kw.get("pre_silu", False)

    def loss(x_, k_, b_, *extra):
        out = jcv.conv3x3_pallas(x_, k_, b_, band=3, pre_silu=silu, **dict(zip(names, extra)))
        return jnp.sum(out * jnp.asarray(dy))

    ref = jax.grad(loss, argnums=tuple(range(3 + len(names))))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), *[jnp.asarray(kw[a]) for a in names])
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in [x, _oihw(k), b] + [kw[a] for a in names]]
    out = tcv.conv3x3(leaves[0], leaves[1], leaves[2], pre_silu=silu,
                      kernel=tcv.conv3x3_fused_reference, **dict(zip(names, leaves[3:])))
    assert type(out.grad_fn).__name__ == "_Conv3x3FunctionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dy))
    np.testing.assert_allclose(got[1].numpy(), _oihw(np.asarray(ref[1])), **MODULE_TOL)
    for i in [0, 2] + list(range(3, len(leaves))):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]), **MODULE_TOL)


def test_conv_input_grad_is_the_flipped_conv():
    """conv3x3_input_grad's plain version equals autograd's input gradient
    of the plain conv (the dU that the kernel computes in the backward)."""
    x, k, _, _, _, _, _, dy = _conv_inputs(3)
    w = torch.from_numpy(_oihw(k))
    xt = torch.from_numpy(x).requires_grad_(True)
    ref, = torch.autograd.grad(tcv.conv3x3_fused_reference(xt, w, None), xt,
                               torch.from_numpy(dy))
    got = tcv.conv3x3_input_grad(torch.from_numpy(dy), w)
    torch.testing.assert_close(got, ref, **CONV_TOL)


def test_conv3x3_module_keeps_its_weight_kernel_ready():
    """The OIHW parameter stays channels_last through dtype casts and strict
    loads, so the kernel's (Co, 3, 3, Ci) view of it needs no copy; the state
    dict keeps diffusers' OIHW shape."""
    m = tb.Conv3x3(16, 32)
    assert m.weight.shape == (32, 16, 3, 3)
    m.load_state_dict({"weight": torch.randn(32, 16, 3, 3), "bias": torch.zeros(32)})
    m.to(torch.bfloat16)
    assert m.weight.permute(0, 2, 3, 1).is_contiguous()
    assert tuple(m.state_dict()["weight"].shape) == (32, 16, 3, 3)


def test_supports_is_structural():
    x, w = torch.zeros(1, 4, 4, 16), torch.zeros(32, 16, 3, 3)
    assert not tcv.supports(x, w)                                   # a CPU tensor
    assert not tcv.supports(x.to(torch.bfloat16)[..., :12], w[:, :12])   # Ci 12


# ------------------------------------------------------------ ResnetBlock2D --

@pytest.mark.parametrize("cin,cout,temb", [(64, 128, 24), (128, 128, 24), (64, 128, None),
                                           (128, 128, None)])
@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas-force"])
def test_resnet_block_fold_form_matches_jax(monkeypatch, cin, cout, temb, pallas):
    """The port's ResnetBlock2D (GN fold, Conv3x3; on the CPU its F.conv2d
    route) against JAX's at its default (GN fold + XLA conv) and with the
    Pallas fused conv forced on (interpret mode; it needs Co >= 128 and
    Ci <= 64 or a multiple of 128, conv3x3.py:213)."""
    rs = np.random.RandomState(cin + (temb or 0))
    x = _rand(rs, 2, 4, 8, cin)
    t = _rand(rs, 2, temb) if temb else None
    jmod = jb.ResnetBlock2D(out_channels=cout)
    jargs = (jnp.asarray(x), None if t is None else jnp.asarray(t))
    monkeypatch.setenv("SVDX_PALLAS_CONV", "0")
    params = jmod.init(jax.random.PRNGKey(cin), *jargs)["params"]
    if pallas:
        monkeypatch.setenv("SVDX_PALLAS_CONV", "force")
    ref = np.asarray(jmod.apply({"params": params}, *jargs))
    tmod = tb.ResnetBlock2D(cin, cout, temb)
    tmod.load_state_dict(diffusers_state_dict(jconv.flatten(params)), strict=True)
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x),
                          None if t is None else torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, ref, **MODULE_TOL)


# ---------------------------------------------------------- head-major flash --

def test_dot_product_attention_flash_matches_pallas_flash():
    """dot_product_attention(impl="flash") on (B, S, H, D) (the plain version
    of the flash kernel on the CPU) against the JAX head-major flash
    attention in interpret mode, and mha against JAX's."""
    from svd_xtend_tpu.ops import attention as jatt
    rs = np.random.RandomState(5)
    q, k, v = (_rand(rs, 1, 128, 2, 64) for _ in range(3))
    ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         scale=0.125))
    got = tatt.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), scale=0.125, impl="flash")
    np.testing.assert_allclose(got.numpy(), ref, **CONV_TOL)
    flat = [a.reshape(1, 128, 128) for a in (q, k, v)]
    ref_mha = np.asarray(jatt.mha(*[jnp.asarray(a) for a in flat], 2, impl="xla"))
    got_mha = tatt.mha(*[torch.from_numpy(a) for a in flat], 2)
    np.testing.assert_allclose(got_mha.numpy(), ref_mha, **CONV_TOL)
    with pytest.raises(ValueError):
        tatt.dot_product_attention(*[torch.from_numpy(a) for a in (q, k, v)], impl="xla")
