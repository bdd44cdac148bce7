"""The port's opt-in int8 W8A8 modes (``ops/quant.py``, the int8 sites of
``Conv3x3`` and ``QLinear``, ``generate(unet_quant=, vae_quant=)``) against
the JAX package's ``ops/quant.py`` on the CPU, in float32 from numpy seeds.

JAX takes an int8 site only where its TPU-measured tables say int8 wins;
``SVDX_INT8_FORCE=1`` (set here with monkeypatch) makes it take every site,
which is the port's structural rule. JAX's functions run jitted, as
``generate`` runs them: XLA then multiplies by f32(1/127) where the source
divides by 127.0, and the port takes that form.

Tolerances: the codes and the scales are bit-exact, and so are the GEMMs'
outputs without a bias (the int32 sums are exact on both sides, the
dequantising product is the same f32 operation). With a bias, XLA on the
CPU contracts the product and the bias add into one fused multiply-add,
which the port (like JAX's source, and the card's kernel) rounds twice:
those outputs are held to ``_fma_close``, two f32 ulps of the output's
largest value. Where an input of the quantisation comes out of f32
arithmetic that XLA and torch order differently (a sigmoid, a LayerNorm, a
product), a value at a rounding boundary can take the next code: that moves
an output by one code's share, |w|·s_x, about 1/127 of the activation's
range times a weight. Such tests hold the max error to ``CODE_TOL`` of the
output's range and the rel-L2 to ``REL_L2`` (both stated beside them).

A whole UNet in int8 is chaotic in such flips: each one moves the next
quantisers' inputs, and they flip in turn. A relative change of 1e-7 in the
port's own input moves its TINY int8 UNet output by about 1 % rel-L2, about
half the quantisation's own error (2 %), while the exact UNet moves by 7e-7.
So the UNet and the videos are held to the size of the quantisation noise
(``_close_by_noise``): the port's int8 output within ``NOISE_RATIO`` times
JAX's own quantisation error of JAX's int8 output, and the port's own
quantisation error the size of JAX's, both measured from the port's exact
output (which test_torch_port_modules.py and test_torch_port_pipeline.py
hold to JAX's exact one at 1e-3). The modules are held exactly (or to a
flip) above, and what the whole adds is wiring: which calls are quantised,
under which scope.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svd_xtend_tpu.core import config as jcfg
from svd_xtend_tpu.diffusion import pipeline as jpipe
from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu.models import blocks as jb
from svd_xtend_tpu.models import transformer as jt
from svd_xtend_tpu.ops import quant as jq
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.diffusion import pipeline as tpipe
from svd_xtend_tpu_torch.io.convert import diffusers_state_dict, state_dict_from_jax
from svd_xtend_tpu_torch.models import blocks as tb
from svd_xtend_tpu_torch.models import transformer as tt
from svd_xtend_tpu_torch.ops import quant
from svd_xtend_tpu_torch.ops.kernels import int8_gemm as ig
from svd_xtend_tpu_torch.ops.kernels import gemm_plan
from svd_xtend_tpu_torch.ops.kernels import int8_quant as iq

torch.set_num_threads(1)

# one flipped code moves an output by about |w|·s_x: held to 2 % of the
# output's range (a single flip in a TINY-width sum is ~1/127 of it)
CODE_TOL = 2e-2
# whole modules: the flips are rare; rel-L2 of the difference
REL_L2 = 1e-2
# whole UNets and videos (the module docstring): the port's distance to
# JAX's int8 output at most this multiple of JAX's int8-to-exact distance,
# and the port's own int8-to-exact distance within this factor of JAX's
NOISE_RATIO = 1.5


@pytest.fixture(autouse=True)
def _force_int8(monkeypatch):
    monkeypatch.setenv("SVDX_INT8_FORCE", "1")
    monkeypatch.delenv("SVDX_INT8_CONV", raising=False)


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close_by_noise(got, ref, exact, what):
    """The port's int8 result `got` against JAX's `ref`, beside the port's
    exact result (the module docstring)."""
    rel = lambda a, b: np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b)
    assert np.isfinite(got).all() and got.shape == ref.shape == exact.shape
    noise, own = rel(ref, exact), rel(got, exact)
    assert rel(got, ref) <= NOISE_RATIO * noise, (what, rel(got, ref), noise)
    assert noise / NOISE_RATIO <= own <= NOISE_RATIO * noise, (what, own, noise)


def _fma_close(got, ref):
    """Within two f32 ulps of ref's largest magnitude: a product rounded
    before the bias add against XLA's fused multiply-add."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -22 * np.abs(ref).max())


def _close_by_codes(got, ref, what):
    """got and ref within one code's share: max error <= CODE_TOL of ref's
    range, rel-L2 <= REL_L2."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
    span = np.abs(ref).max()
    assert err <= CODE_TOL * span and rel <= REL_L2, (what, err, span, rel)


# -------------------------------------------------------------- the ops --

@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_dynamic_matches_jitted_jax(scale, dtype):
    x = _rand(0, 3, 5, 7, 24, scale=scale)
    jx = jnp.asarray(x).astype(dtype)
    codes, s = jax.jit(jq.quantize_dynamic)(jx)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got, got_s = quant.quantize_dynamic(tx)
    # bit for bit against the jitted form
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(codes))
    assert np.float32(got_s.item()).tobytes() == np.float32(s).tobytes()
    # the kernel's plain version: the same codes, stats = (amax, scale)
    q2, stats = iq.quantize(tx)
    np.testing.assert_array_equal(q2.numpy(), np.asarray(codes))
    assert stats[0].item() == float(np.abs(np.asarray(jx.astype(jnp.float32))).max())
    assert stats[1].item() == got_s.item()
    # the eager JAX function divides by 127.0: within one code
    eager, _ = jq.quantize_dynamic(jx)
    assert np.abs(got.numpy().astype(int) - np.asarray(eager).astype(int)).max() <= 1


def test_weight_quantisers_match_jitted_jax():
    w = _rand(1, 3, 3, 24, 16, scale=0.2)                      # HWIO
    codes, s = jax.jit(jq.quantize_weight_per_co)(jnp.asarray(w))
    got, got_s = quant.quantize_weight_per_co(_t(w.transpose(3, 2, 0, 1)))   # OIHW
    np.testing.assert_array_equal(got.numpy(), np.asarray(codes).transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(s))
    k = _rand(2, 40, 24, scale=0.2)                            # (Cin, Cout)
    codes, s = jax.jit(jq.quantize_weight_per_cout)(jnp.asarray(k))
    got, got_s = quant.quantize_weight_per_cout(_t(k.T))       # nn.Linear (Cout, Cin)
    np.testing.assert_array_equal(got.numpy(), np.asarray(codes).T)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(s))


@pytest.mark.parametrize("epi", ["none", "bias", "bias+post", "bias+res", "bias+post+res"])
def test_int8_conv3x3_matches_jax(epi):
    """JAX's int8_conv3x3 (jitted) against the port's plain version: bit for
    bit without a bias, else ``_fma_close``; the kernel wrapper's CPU route
    equal to the plain version."""
    x = _rand(3, 2, 5, 6, 16)
    w = _rand(4, 3, 3, 16, 24, scale=0.1)
    bias = _rand(5, 24, scale=0.1) if "bias" in epi else None
    post = _rand(6, 2, 24) if "post" in epi else None
    res = _rand(7, 2, 5, 6, 24) if "res" in epi else None
    j = lambda *a: jq.int8_conv3x3(*a[:3], post_shift=a[3], residual=a[4])
    ref = np.asarray(jax.jit(j)(*[None if a is None else jnp.asarray(a)
                                  for a in (x, w, bias, post, res)]))
    tw = _t(w.transpose(3, 2, 0, 1))
    tv = lambda a: None if a is None else _t(a)
    got = quant.int8_conv3x3_reference(_t(x), tw, tv(bias), tv(post), tv(res))
    (np.testing.assert_array_equal if bias is None else _fma_close)(got.numpy(), ref)
    xq, stats = iq.quantize(_t(x))
    wq, w_amax = ig.conv_codes(tw)
    got2 = ig.int8_conv3x3(xq, stats, wq, w_amax, tv(bias), tv(post), tv(res), torch.float32)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


def _tiled_conv_sums(xq, wq, k_bytes, k_slices):
    """The int32 sums of the int8 conv as the wgmma kernels take them: K
    tile kt is k_bytes channels (kt % cblocks)·k_bytes.. of tap kt //
    cblocks, A's pixels shifted by the tap with the SAME padding and both
    operands zero past Ci (TMA's fill), the tiles of each K slice summed in
    int32 and the slices added (csrc/int8_gemm.cu, gemm_plan.slice_bounds)."""
    n, h, w, ci = xq.shape
    cblocks = -(-ci // k_bytes)
    pad = torch.zeros(n, h + 2, w + 2, cblocks * k_bytes, dtype=torch.int64)
    pad[:, 1:-1, 1:-1, :ci] = xq.long()
    wt = torch.zeros(wq.shape[0], 9, cblocks * k_bytes, dtype=torch.int64)
    wt[..., :ci] = wq.reshape(wq.shape[0], 9, ci).long()
    total = 0
    for k0, k1 in gemm_plan.slice_bounds(9 * cblocks, k_slices):
        part = torch.zeros(n, h, w, wq.shape[0], dtype=torch.int64)
        for kt in range(k0, k1):
            tap, c0 = kt // cblocks, (kt % cblocks) * k_bytes
            a = pad[:, tap // 3:tap // 3 + h, tap % 3:tap % 3 + w, c0:c0 + k_bytes]
            part += a @ wt[:, tap, c0:c0 + k_bytes].T
        assert part.abs().max() < 2 ** 31       # each slice's int32 partials
        total = total + part
    return total.to(torch.int32)


@pytest.mark.parametrize("ci", [64, 320, 960])
def test_int8_conv_tiles_match_jax(ci):
    """The wgmma kernels' K tiling of the conv (per-tap tiles of 128 codes,
    a tap whose Ci is not a multiple of the tile ending in zero-filled
    channels, K split into slices) reproduces the exact int32
    sums of the plain version, and, dequantised, JAX's int8_conv3x3 bit for
    bit (no bias), at Ci 320 and 960, whose taps end mid-tile at 128."""
    x = _rand(11, 2, 5, 6, ci)
    w = _rand(12, 3, 3, ci, 24, scale=0.1)
    ref = np.asarray(jax.jit(jq.int8_conv3x3)(jnp.asarray(x), jnp.asarray(w)))
    xq, stats = iq.quantize(_t(x))
    wq, w_amax = ig.conv_codes(_t(w.transpose(3, 2, 0, 1)))
    exact = quant.conv_accumulate(xq, wq)
    for k_slices in (1, 2, 3):
        sums = _tiled_conv_sums(xq, wq, ig.INT8_K_TILE, k_slices)
        assert torch.equal(sums, exact), k_slices
    got = quant.dequantize(sums, stats[0], w_amax, None, torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("k", [64, 320, 1024])
def test_int8_dense_tiles_match_jax(k):
    """The dense K in tiles of 128 codes, the last zero-filled past K
    (K 320 at 128), in 1-3 slices: the plain version's exact sums and,
    dequantised, JAX's int8_dense bit for bit (no bias)."""
    x = _rand(13, 7, k)
    wk = _rand(14, k, 24, scale=0.1)
    ref = np.asarray(jax.jit(jq.int8_dense)(jnp.asarray(x), jnp.asarray(wk), None))
    xq, stats = iq.quantize(_t(x))
    wq, w_amax = ig.dense_codes(_t(wk.T))
    exact = quant.dense_accumulate(xq, wq)
    kb = ig.INT8_K_TILE
    tiles = -(-k // kb)
    a = torch.zeros(7, tiles * kb, dtype=torch.int64)
    b = torch.zeros(24, tiles * kb, dtype=torch.int64)
    a[:, :k], b[:, :k] = xq.long(), wq.long()
    for k_slices in (1, 2, 3):
        sums = sum(a[:, k0 * kb:k1 * kb] @ b[:, k0 * kb:k1 * kb].T
                   for k0, k1 in gemm_plan.slice_bounds(tiles, k_slices) if k1 > k0)
        assert torch.equal(sums.to(torch.int32), exact), k_slices
    got = quant.dequantize(exact, stats[0], w_amax, None, torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bias", [False, True])
def test_int8_dense_matches_jax(bias):
    x = _rand(8, 2, 7, 40)
    k = _rand(9, 40, 24, scale=0.1)
    b = _rand(10, 24, scale=0.1) if bias else None
    ref = np.asarray(jax.jit(jq.int8_dense)(jnp.asarray(x), jnp.asarray(k),
                                            None if b is None else jnp.asarray(b)))
    got = quant.int8_dense_reference(_t(x), _t(k.T), None if b is None else _t(b))
    (np.testing.assert_array_equal if b is None else _fma_close)(got.numpy(), ref)


# ------------------------------------------------------------ the sites --

def _load(tmod, params):
    tmod.load_state_dict(diffusers_state_dict(jconv.flatten(params)), strict=True)
    return tmod.eval()


@pytest.mark.parametrize("form", ["plain", "pre+post", "pre+res", "x2+pre+post"])
def test_conv3x3_module_int8_matches_jax(form):
    """Conv3x3 in int8 mode: the prologue (f32 affine + SiLU, rounded),
    the activation quantised over [x, x2], the int8 conv with the shift or
    the residual; JAX's Conv3x3 under quantized("int8")."""
    c1, c2, co = 16, 24 if "x2" in form else 0, 32
    x = _rand(11, 2, 5, 6, c1)
    x2 = _rand(12, 2, 5, 6, c2) if c2 else None
    pre = (1 + _rand(13, 2, c1 + c2, scale=0.2), _rand(14, 2, c1 + c2, scale=0.2)) \
        if "pre" in form else None
    post = _rand(15, 2, co) if "post" in form else None
    res = _rand(16, 2, 5, 6, co) if "res" in form else None
    jmod = jb.Conv3x3(co)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       x2=None if x2 is None else jnp.asarray(x2))["params"]
    jpre = None if pre is None else (jnp.asarray(pre[0]), jnp.asarray(pre[1]), True)

    def jf(p, x, post, res, x2):
        with jq.quantized("int8"):
            return jmod.apply({"params": p}, x, pre=jpre, post_shift=post, residual=res, x2=x2)

    ref = np.asarray(jax.jit(jf)(params, *[None if a is None else jnp.asarray(a)
                                           for a in (x, post, res, x2)]))
    tmod = _load(tb.Conv3x3(c1 + c2, co), params)
    tv = lambda a: None if a is None else _t(a)
    tpre = None if pre is None else (_t(pre[0]), _t(pre[1]), True)
    with torch.no_grad(), quant.quantized("int8"):
        got = tmod(_t(x), pre=tpre, post_shift=tv(post), residual=tv(res), x2=tv(x2)).numpy()
    _close_by_codes(got, ref, form)
    # the exact mode differs from int8 by the quantisation's own error
    with torch.no_grad():
        exact = tmod(_t(x), pre=tpre, post_shift=tv(post), residual=tv(res), x2=tv(x2)).numpy()
    assert np.abs(exact - got).max() > 0


@pytest.mark.parametrize("bias,lead", [(True, (2, 7)), (False, (3, 1, 5))])
def test_qlinear_matches_qdense(bias, lead):
    x = _rand(17, *lead, 40)
    jmod = jt.QDense(24, use_bias=bias)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]

    def jf(p, x):
        with jq.quantized("int8"):
            return jmod.apply({"params": p}, x)

    ref = np.asarray(jax.jit(jf)(params, jnp.asarray(x)))
    tmod = tt.QLinear(40, 24, bias=bias)
    with torch.no_grad():
        tmod.weight.copy_(_t(np.asarray(params["kernel"]).T))
        if bias:
            tmod.bias.copy_(_t(np.asarray(params["bias"])))
        with quant.quantized("int8"):
            got = tmod(_t(x)).numpy()
        exact = tmod(_t(x)).numpy()
    (_fma_close if bias else np.testing.assert_array_equal)(got, ref)
    np.testing.assert_allclose(exact, np.asarray(jmod.apply({"params": params}, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


class _RG(torch.nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm3 = torch.nn.LayerNorm(dim, eps=1e-5)
        self.ff = tt.FeedForward(dim)


def test_residual_geglu_int8_matches_jax():
    """Under int8, residual_geglu is LN -> QLinear -> h·gelu_tanh(gate) ->
    QLinear -> + x (the fused kernel off, as JAX's ResidualGEGLU)."""
    x = _rand(18, 2, 20, 32)
    jmod = jt.ResidualGEGLU(32, ln_name="norm3", ff_name="ff")
    params = jmod.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]

    def jf(p, x):
        with jq.quantized("int8"):
            return jmod.apply({"params": p}, x)

    ref = np.asarray(jax.jit(jf)(params, jnp.asarray(x)))
    tmod = _load(_RG(32), params)
    with torch.no_grad(), quant.quantized("int8"):
        got = tt.residual_geglu(_t(x), tmod.norm3, tmod.ff).numpy()
    _close_by_codes(got - x, ref - x, "residual_geglu")


@pytest.mark.parametrize("temporal", [False, True])
def test_transformer_blocks_int8_match_jax(temporal):
    shape = (2, 4, 10, 64) if temporal else (2, 40, 64)
    x = _rand(19, *shape)
    ctx = _rand(20, 2, 1, 32)
    jcls = jt.TemporalBasicTransformerBlock if temporal else jt.BasicTransformerBlock
    tcls = tt.TemporalBasicTransformerBlock if temporal else tt.BasicTransformerBlock
    jmod = jcls(1, 64)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(ctx))["params"]

    def jf(p, x, c):
        with jq.quantized("int8"):
            return jmod.apply({"params": p}, x, c)

    ref = np.asarray(jax.jit(jf)(params, jnp.asarray(x), jnp.asarray(ctx)))
    tmod = _load(tcls(64, 1, 64, 32), params)
    with torch.no_grad(), quant.quantized("int8"):
        got = tmod(_t(x), _t(ctx)).numpy()
    _close_by_codes(got - x, ref - x, "block")


# ------------------------------------------------ the UNet and generate --

CFG_KW = dict(height=32, width=32, num_frames=2, num_inference_steps=2, decode_chunk_size=2)
MODES = {"unet": dict(unet_quant="int8"), "both": dict(unet_quant="int8", vae_quant="int8")}


@pytest.fixture(scope="module")
def models():
    """The JAX pipeline's TINY models and weights, and the port's with them."""
    jm = jpipe.SVDModels(unet_config=jcfg.TINY_UNET, vae_config=jcfg.TINY_VAE,
                         clip_config=jcfg.TINY_CLIP, dtype=jnp.float32)
    params = jpipe.init_pipeline_params(jm, jax.random.PRNGKey(0))
    tm = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP, device="cpu")
    sds = state_dict_from_jax(jconv.flatten(params))
    for net in ("unet", "vae", "clip"):
        getattr(tm, net).load_state_dict(sds[net], strict=True)
    return jm, params, tm


def test_unet_int8_matches_jax_tiny(models):
    """One TINY UNet pass (every Conv3x3 and QLinear in int8) against JAX's
    under quantized("int8"), to the quantisation noise (_close_by_noise)."""
    jm, params, tm = models
    b, f = 2, 3
    rs = np.random.RandomState(21)
    sample = rs.randn(b, f, 8, 8, jcfg.TINY_UNET.in_channels).astype(np.float32)
    ehs = rs.randn(b, 1, jcfg.TINY_UNET.cross_attention_dim).astype(np.float32)
    ids = np.tile(np.array([[6.0, 127.0, 0.02]], np.float32), (b, 1))
    t = np.float32(0.25 * np.log(37.0))
    unet = jm.unet()

    def jf(p, *a):
        with jq.quantized("int8"):
            return unet.apply({"params": p}, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SVDX_INT8_FORCE", "1")
        ref = np.asarray(jax.jit(jf)(params["unet"],
                                     *[jnp.asarray(a) for a in (sample, t, ehs, ids)]))
    targs = (_t(sample), torch.tensor(t), _t(ehs), _t(ids))
    with torch.no_grad():
        with quant.quantized("int8"):
            got = tm.unet(*targs).numpy()
        got_exact = tm.unet(*targs).numpy()
    _close_by_noise(got, ref, got_exact, "unet")


@pytest.fixture(scope="module")
def generated(models):
    """JAX's generate, once per mode, at 2 steps and 2 frames."""
    jm, params, tm = models
    image = np.random.RandomState(1).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SVDX_INT8_FORCE", "1")
        refs = {name: np.asarray(jpipe.generate(jm, params, jnp.asarray(image), rng,
                                                jcfg.PipelineConfig(**CFG_KW, **kw)))
                for name, kw in MODES.items()}
    k_cond, k_init = jax.random.split(rng)
    k_aug, _ = jax.random.split(k_cond)
    h8 = 32 // jcfg.TINY_VAE.downsample_factor
    noise = (np.array(jax.random.normal(k_aug, image.shape, jnp.float32)),
             np.array(jax.random.normal(k_init, (1, 2, h8, h8, 4), jnp.float32)))
    return tm, image, noise, refs


@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_int8_matches_jax(generated, mode):
    tm, image, (img_noise, lat_noise), refs = generated
    got = tpipe.generate(tm, _t(image), tcfg.PipelineConfig(**CFG_KW, **MODES[mode]),
                         image_noise=_t(img_noise), latent_noise=_t(lat_noise)).numpy()
    assert got.shape == refs[mode].shape == (1, 2, 32, 32, 3)
    assert quant.get_mode() is None          # the scopes are closed again
    exact = tpipe.generate(tm, _t(image), tcfg.PipelineConfig(**CFG_KW),
                           image_noise=_t(img_noise), latent_noise=_t(lat_noise)).numpy()
    _close_by_noise(got, refs[mode], exact, mode)


def test_mode_gate():
    assert quant.get_mode() is None
    with quant.quantized("int8"):
        assert quant.get_mode() == "int8"
        with quant.quantized(None):
            assert quant.get_mode() is None
        assert quant.get_mode() == "int8"
    assert quant.get_mode() is None
    with pytest.raises(ValueError, match="unknown quant mode"):
        quant.set_mode("int4")
    with pytest.raises(ValueError, match="unknown quant mode"):
        with quant.quantized("fp8"):
            pass
    assert quant.get_mode() is None


def test_prepare_makes_every_site_code_once():
    """prepare_int8 makes the codes of every Conv3x3 and QLinear before the
    loop; the cache returns the same tensors until a weight changes."""
    m = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    sites = [mod for mod in m.unet.modules() if isinstance(mod, (tb.Conv3x3, tt.QLinear))]
    assert tpipe.prepare_int8(m.unet) == sum(
        mod.weight.numel() + 4 * mod.weight.shape[0] for mod in sites)
    first = sites[0].int8_codes()
    assert sites[0].int8_codes()[0] is first[0]
    with torch.no_grad():
        sites[0].weight.mul_(2.0)
    assert sites[0].int8_codes()[0] is not first[0]
    # the tracklet branch's projections, the embeddings and CLIP keep
    # nn.Linear (nn.Dense in JAX); the branch's feed-forwards are JAX's
    # FeedForward, whose projections are QDense
    tr = dataclasses.replace(tcfg.TINY_UNET, tracklet_dim=8)
    mt = tpipe.SVDModels.create(tr, tcfg.TINY_VAE, tcfg.TINY_CLIP, device="cpu")
    q = lambda net: {n for n, mod in net.named_modules() if isinstance(mod, tt.QLinear)}
    assert q(mt.unet.tracklet_conditioner) == {"enhancer.ff.net.0.proj", "enhancer.ff.net.2"}
    gated = mt.unet.down_blocks[0].attentions[0].gated_attentions[0]
    assert q(gated) == {"ff.net.0.proj", "ff.net.2"}
    assert not q(mt.clip) and not q(mt.unet.time_embedding)


@pytest.mark.parametrize("batch", [2, 1])
def test_int8_site_tables_count_a_tiny_pass(monkeypatch, batch):
    """sites.int8_dense_sites, the int8 conv count and the quantise calls,
    which chip_smoke.py holds the card's launches to at full size, against
    the calls a TINY UNet pass makes (a CFG pair and a cond-only pass):
    every QLinear by its GEMM's (rows, K, N) (net.2's quantise reads
    net.0.proj's (rows, 2K) output, the gate), one conv site per Conv3x3,
    and one quantise call a site but for the self-attentions' to_k and to_v
    (sites.int8_quantize_calls), each QLinear input by its shape
    (sites.int8_quantise_sites)."""
    from svd_xtend_tpu_torch.ops.kernels import int8_quant as iq
    from svd_xtend_tpu_torch.scripts import sites
    m = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    calls = {}
    dense, conv, quantize = ig.linear_site, ig.conv3x3_site, iq.quantize

    def count_dense(x, weight, bias=None, group=None, **kw):
        key = (x.numel() // x.shape[-1], weight.shape[1], weight.shape[0])
        assert x.shape[-1] == (2 if kw.get("gate") else 1) * weight.shape[1]
        calls[key] = calls.get(key, 0) + 1
        calls["gate"] = calls.get("gate", 0) + bool(kw.get("gate"))
        return dense(x, weight, bias, group, **kw)

    def count_conv(*a, **kw):
        calls["conv"] = calls.get("conv", 0) + 1
        return conv(*a, **kw)

    def count_quantize(x, *a, **kw):
        calls["quantize"] = calls.get("quantize", 0) + 1
        if x.dim() == 2:    # a QLinear's input, by (rows, width, code width)
            key = ("q", x.shape[0], x.shape[1], x.shape[1] // (2 if kw.get("gate") else 1))
            calls[key] = calls.get(key, 0) + 1
        return quantize(x, *a, **kw)

    monkeypatch.setattr(ig, "linear_site", count_dense)
    monkeypatch.setattr(ig, "conv3x3_site", count_conv)
    monkeypatch.setattr(iq, "quantize", count_quantize)
    f, h = 3, 16
    x = torch.randn(batch, f, h // 2, h // 2, tcfg.TINY_UNET.in_channels)
    ehs = torch.randn(batch, 1, tcfg.TINY_UNET.cross_attention_dim)
    with torch.no_grad(), quant.quantized("int8"):
        m.unet(x, torch.tensor(0.5), ehs, torch.ones(batch, 3))
    shape = dict(height=h, width=h, frames=f, batch=batch, downsample=2)
    want = sites.int8_dense_sites(tcfg.TINY_UNET, **shape)
    n_conv = sum(1 for mod in m.unet.modules() if isinstance(mod, tb.Conv3x3))
    assert calls.pop("conv") == n_conv == sites.int8_conv_calls(tcfg.TINY_UNET)
    assert calls.pop("quantize") == sites.int8_quantize_calls(tcfg.TINY_UNET, **shape)
    quantised = {k[1:]: calls.pop(k) for k in list(calls) if k[0] == "q"}
    assert quantised == {st[:3]: st[3] for st in sites.int8_quantise_sites(tcfg.TINY_UNET,
                                                                           **shape)}
    assert calls.pop("gate") == sum(st[3] for st in sites.int8_gate_sites(tcfg.TINY_UNET,
                                                                           **shape))
    assert calls == {st[:3]: st[3] for st in want}
    # the full-size tables: 46 convs and 320 dense calls a CFG pass, 30 convs a
    # decode chunk; 302 quantise calls a pass, 48 of them at the gate
    assert sum(st[5] for st in sites.INT8_CONV_SITES) == 46 == sites.int8_conv_calls()
    assert sum(st[5] for st in sites.INT8_VAE_CONV_SITES) == 30
    assert sum(st[3] for st in sites.INT8_DENSE_SITES) == 320
    assert sites.INT8_QUANTIZE_CALLS == 302 == sites.int8_quantize_calls(batch=1)
    assert sum(st[3] for st in sites.INT8_GATE_SITES) == 48


def test_int8_composes_with_boxes_cache_and_merged_lora():
    """The int8 modes with a tracklet UNet and boxes under the CFG cache and
    DeepCache, and with a merged LoRA UNet: finite videos in [-1, 1] that
    move off the exact ones (TINY, on the CPU)."""
    from svd_xtend_tpu_torch.models import lora
    unet_cfg = dataclasses.replace(tcfg.TINY_UNET, tracklet_dim=8, tracklet_gate_init=0.5)
    g = torch.Generator().manual_seed(0)
    m = tpipe.SVDModels.create(unet_cfg, tcfg.TINY_VAE, tcfg.TINY_CLIP, device="cpu",
                               generator=g)
    image = torch.rand(1, 32, 32, 3, generator=g) * 2 - 1
    boxes, mask = torch.rand(1, 2, 3, 4, generator=g), torch.ones(1, 2, 3)
    kw = dict(height=32, width=32, num_frames=2, num_inference_steps=4, decode_chunk_size=2)
    run = lambda cfg: tpipe.generate(m, image, cfg, generator=torch.Generator().manual_seed(1),
                                     boxes=boxes, box_mask=mask)
    for cache in (dict(uncond_reuse_interval=2), dict(deep_cache_interval=2)):
        exact = run(tcfg.PipelineConfig(**kw, **cache))
        got = run(tcfg.PipelineConfig(**kw, **cache, unet_quant="int8", vae_quant="int8"))
        assert torch.isfinite(got).all() and got.abs().max() <= 1.0
        assert 0 < (got - exact).abs().max() < 0.5
    adapter = lora.init(m.unet, 2, torch.Generator().manual_seed(2))
    for ab in adapter.values():
        ab["b"].normal_(0, 0.02, generator=torch.Generator().manual_seed(3))
    lora.merge_(m.unet, adapter)
    got = run(tcfg.PipelineConfig(**kw, unet_quant="int8"))
    assert torch.isfinite(got).all()
