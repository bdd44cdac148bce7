"""The plain versions of the port's probe kernels against the JAX package's
TPU probe kernels, run in Pallas interpret mode on the CPU, on the same
seeded numpy inputs:

- ``flash_variants_reference`` against ``scripts/microbench_flash_variants.py``'s
  ``_kernel`` through its ``run`` (whose ``pl.pallas_call`` is given
  ``interpret=True`` here), in the four modes;
- ``flash_attention_headsliced`` (its plain version on the CPU) against
  ``scripts/microbench_flash_headslice.py::_fwd_headsliced``: out, and the
  port's (B, H, S) LSE against the TPU's (B, H*8, S) one at row 8h;
- ``chain_bf16_reference`` / ``chain_int8_qd_reference`` against
  ``scripts/probe_int8_flash.py``'s ``_chain_bf16`` / ``_chain_int8_qd`` at
  ``N_INNER`` of 1, 2 and 4 (the values do not survive many more steps).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa
from svd_xtend_tpu_torch.ops.kernels import flash_chain as fc
from svd_xtend_tpu_torch.ops.kernels import flash_variants as fv

torch.set_num_threads(1)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def _load_script(name):
    """Import a JAX probe script; it sets the persistent compilation cache on
    import, so the settings are put back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(f"tpu_probe_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def variants():
    return _load_script("microbench_flash_variants")


@pytest.fixture(scope="module")
def headslice():
    return _load_script("microbench_flash_headslice")


@pytest.fixture(scope="module")
def chain():
    return _load_script("probe_int8_flash")


def _bf16_ulps(ref, n=4.0):
    """n bf16 ulps of the scale of `ref`."""
    scale = float(np.abs(ref).max())
    return n * 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", fv.MODES)
@pytest.mark.parametrize("bh,s", [(2, 256), (3, 384)])
def test_flash_variants_plain_matches_tpu_kernel(variants, monkeypatch, bh, s, mode, dtype):
    """At S = 256 the TPU kernel takes one 256-key major tile (base: two
    128-key sub-tiles); at S = 384, three 128-key tiles. In f32 the two differ
    only in summation order and the running maximum (2e-5); in bf16 the
    weights are rounded to bf16 at a running maximum there and at the row's
    maximum here (4 bf16 ulps of the output's scale). nosoftmax divides by
    the row sum of the raw scores, so it gets positive (uniform) q and k."""
    rs = np.random.RandomState(bh * 1000 + s)
    draw = rs.rand if mode == "nosoftmax" else rs.randn
    q, k = (draw(bh, s, 64).astype(np.float32) for _ in range(2))
    v = rs.randn(bh, s, 64).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
    monkeypatch.setattr(variants.pl, "pallas_call",
                        functools.partial(variants.pl.pallas_call, interpret=True))
    ref = np.asarray(variants.run(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125,
                                  mode), np.float32)
    tt = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
    got = fv.flash_variants(tt(q), tt(k), tt(v), scale=0.125, mode=mode).float().numpy()
    atol = 2e-5 * max(1.0, float(np.abs(ref).max())) if dtype == "float32" else _bf16_ulps(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_flash_variants_refuses_unknown_mode():
    x = torch.zeros(1, 128, 64)
    with pytest.raises(ValueError, match="mode"):
        fv.flash_variants(x, x, x, scale=0.1, mode="softmax2")


@pytest.mark.parametrize("s,h", [(256, 2), (384, 1)])
def test_flash_attention_headsliced_matches_tpu_kernel(headslice, s, h):
    """f32: out and LSE agree up to summation order (2e-5). The TPU kernel
    writes each head's LSE to 8 replicated rows; the port keeps one."""
    rs = np.random.RandomState(s)
    q, k, v = (rs.randn(1, s, h * 64).astype(np.float32) for _ in range(3))
    out, lse = headslice._fwd_headsliced(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         0.125, h)
    got_o, got_lse = fa.flash_attention_headsliced(
        *(torch.from_numpy(a) for a in (q, k, v)), scale=0.125, num_heads=h)
    assert got_lse.shape == (1, h, s)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(out), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[:, ::8], rtol=0, atol=2e-5)


def _chain_inputs(seed, bq=64, bkm=128):
    """The probe's recipe: normal bf16 q, kᵀ, v; int8 kᵀ, v = clip(round(20x))."""
    rs = np.random.RandomState(seed)
    q, kT, v = (rs.randn(*shape).astype(ml_dtypes.bfloat16)
                for shape in ((bq, 64), (64, bkm), (bkm, 64)))
    to8 = lambda a: np.clip(np.round(a.astype(np.float32) * 20), -127, 127).astype(np.int8)
    return q, kT, v, to8(kT), to8(v)


def _tpu_chain(mod, kernel, q, kT, v):
    """The probe's `run` without its timing loop: one pallas_call, interpreted."""
    pl = mod.pl
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((q.shape[0], mod.D), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=mod.pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec(memory_space=mod.pltpu.VMEM), interpret=True,
    )(jnp.asarray(q), jnp.asarray(kT), jnp.asarray(v)))


@pytest.mark.parametrize("n_inner", [1, 2, 4])
def test_flash_chains_plain_match_tpu_kernels(chain, monkeypatch, n_inner):
    """int8_qd bit for bit (int32 sums, the same f32 roundings in the same
    order). bf16 within 4 bf16 ulps of the output's scale: XLA and torch sum
    the f32 products in another order, so a rounding of p or q to bf16 may
    land one ulp apart."""
    monkeypatch.setattr(chain, "N_INNER", n_inner)
    q, kT, v, kTi, vi = _chain_inputs(n_inner)
    t = lambda a: torch.from_numpy(np.asarray(a.astype(np.float32))).to(
        torch.int8 if a.dtype == np.int8 else torch.bfloat16)
    ref8 = _tpu_chain(chain, chain._chain_int8_qd, q, kTi, vi)
    got8 = fc.chain_int8_qd(t(q), t(kTi), t(vi), n_inner).numpy()
    assert np.isfinite(ref8).all()
    np.testing.assert_array_equal(got8, ref8)
    ref = _tpu_chain(chain, chain._chain_bf16, q, kT, v)
    got = fc.chain_bf16(t(q), t(kT), t(v), n_inner).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_bf16_ulps(ref))


def test_quant_scale_matches_xla():
    """The int8 chain's scale s = max|x|/127 + 1e-12 as the JAX function
    computes it: XLA compiles the division by the constant 127 as a product
    with its f32 reciprocal, which differs from a division in the last bit
    for about 5 % of maxima, and then rounds x / s differently."""
    xla = jax.jit(lambda x: jnp.max(jnp.abs(x)) / 127.0 + 1e-12)
    rs = np.random.RandomState(0)
    xs = [(rs.randn(64) * rs.uniform(0.1, 1000)).astype(np.float32) for _ in range(400)]
    got = np.array([fc._quant(torch.from_numpy(x))[1].item() for x in xs], np.float32)
    np.testing.assert_array_equal(got, np.array([xla(x) for x in xs], np.float32))


@pytest.mark.parametrize("n_inner", [1, 2, 4])
def test_flash_chain_kernel_arithmetic_matches_tpu_kernels(chain, monkeypatch, n_inner):
    """The card kernels' arithmetic as plain functions: the int8 chain with
    p's scale from the int32 scores' maximum (its one-pass max) bit for bit
    the TPU kernel and the plain chain; the bf16 chain with the cluster's
    key split (partial P·V summed in rank order), at 2 and 4 blocks, within
    4 bf16 ulps of the TPU kernel, as the plain chain is."""
    monkeypatch.setattr(chain, "N_INNER", n_inner)
    q, kT, v, kTi, vi = _chain_inputs(n_inner + 10, bq=64, bkm=256)
    t = lambda a: torch.from_numpy(np.asarray(a.astype(np.float32))).to(
        torch.int8 if a.dtype == np.int8 else torch.bfloat16)
    ref8 = _tpu_chain(chain, chain._chain_int8_qd, q, kTi, vi)
    got8 = fc.chain_int8_qd_intmax_reference(t(q), t(kTi), t(vi), n_inner).numpy()
    np.testing.assert_array_equal(got8, ref8)
    np.testing.assert_array_equal(got8, fc.chain_int8_qd_reference(t(q), t(kTi), t(vi),
                                                                   n_inner).numpy())
    ref = _tpu_chain(chain, chain._chain_bf16, q, kT, v)
    for cluster in (2, 4):
        got = fc.chain_bf16_split_reference(t(q), t(kT), t(v), n_inner, cluster).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=_bf16_ulps(ref))
