"""The port's LoRA (models/lora.py) and attention processors
(models/attn_processor.py) against the JAX package on the CPU, at TINY_UNET
in float32 (and a bf16 base for the merge), with the JAX-initialised
weights carried by the port's converter; and the port's adapter against
peft's on the same module.

The adapters start from JAX's A and a seeded nonzero B: while B is zero the
merged weights equal the base ones, which would hide a wrong merge."""

import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svd_xtend_tpu.core import config as jcfg
from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu.models import attn_processor as JAP
from svd_xtend_tpu.models import lora as jlora
from svd_xtend_tpu.models.unet import UNetSpatioTemporalConditionModel as JUNet
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.io.convert import (_module_key, diffusers_state_dict, lora_from_jax,
                                            lora_state_dict)
from svd_xtend_tpu_torch.models import attn_processor as AP
from svd_xtend_tpu_torch.models import lora
from svd_xtend_tpu_torch.models.unet import UNetSpatioTemporalConditionModel
from svd_xtend_tpu_torch.ops.attention import dot_product_attention, merge_heads, split_heads

torch.set_num_threads(1)

# f32 UNet forwards: summation order only (XLA vs torch CPU kernels)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    """The JAX TINY UNet with its params, the port's UNet with the same
    weights, and one input (the JAX processor tests' shapes)."""
    rs = np.random.RandomState(0)
    inputs = (rs.randn(2, 2, 8, 8, 8).astype(np.float32), np.full((2,), 10.0, np.float32),
              rs.randn(2, 1, jcfg.TINY_UNET.cross_attention_dim).astype(np.float32),
              np.ones((2, 3), np.float32))
    junet = JUNet(jcfg.TINY_UNET, dtype=jnp.float32)
    params = jax.jit(junet.init)(jax.random.PRNGKey(0), *map(jnp.asarray, inputs))["params"]
    unet = UNetSpatioTemporalConditionModel(tcfg.TINY_UNET).eval().requires_grad_(False)
    unet.load_state_dict(diffusers_state_dict(jconv.flatten(params)), strict=True)
    return junet, params, unet, inputs


def jax_adapter(params, seed=3):
    """JAX's init (A gaussian / r) with B replaced by a seeded nonzero draw."""
    rs = np.random.RandomState(seed)
    return {path: {"a": np.asarray(ab["a"]),
                   "b": (rs.randn(*ab["b"].shape) * 0.1).astype(np.float32)}
            for path, ab in jlora.init(jax.random.PRNGKey(seed), params).items()}


def _jax_apply(junet, params, inputs):
    return np.asarray(junet.apply({"params": params}, *map(jnp.asarray, inputs)))


def _port_apply(unet, inputs):
    with torch.no_grad():
        return unet(*map(torch.from_numpy, inputs)).numpy()


# ------------------------------------------------------------------ LoRA --

def test_targets_match_jax_target_paths(pair):
    """The same projections in the same order, (out, in) for JAX's (in, out);
    TINY has 4 transformer models x 4 attentions x 4 projections."""
    _, params, unet, _ = pair
    want = [(_module_key(path[: -len("/kernel")]), tuple(reversed(shape)))
            for path, shape in jlora.target_paths(params)]
    assert lora.targets(unet) == want
    assert len(want) == 64


def test_init_draws_a_and_zero_b(pair):
    _, params, unet, _ = pair
    ad = lora.init(unet, rank=4, generator=torch.Generator().manual_seed(0))
    assert list(ad) == [n for n, _ in lora.targets(unet)]
    for name, (d_out, d_in) in lora.targets(unet):
        a, b = ad[name]["a"], ad[name]["b"]
        assert a.shape == (4, d_in) and b.shape == (d_out, 4)
        assert a.dtype == b.dtype == torch.float32
        assert not b.any() and a.std().item() > 0
    every_a = torch.cat([ab["a"].flatten() for ab in ad.values()]) * 4
    assert abs(every_a.std().item() - 1.0) < 0.05 and abs(every_a.mean().item()) < 0.05
    assert lora.num_params(ad) == jlora.num_params(jlora.init(jax.random.PRNGKey(0), params))
    again = lora.init(unet, rank=4, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(ad[n]["a"], again[n]["a"]) for n in ad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_matches_jax(pair, dtype):
    """W + (alpha/r)·A@B cast back to W's dtype: within 1e-6 relative in
    f32, within 1 bf16 ulp of JAX's on a bf16 base (the f32 deltas may
    round across a bf16 boundary)."""
    _, params, unet, _ = pair
    jtree = jax_adapter(params)
    base = jax.tree.map(lambda x: x.astype(dtype), params)
    ref = jconv.flatten(jlora.merge(base, jtree, rank=4, alpha=4.0))
    tunet = copy.deepcopy(unet).to(getattr(torch, dtype))
    got = lora.merge(tunet, lora_from_jax(jtree), alpha=4.0)
    assert set(got) == {_module_key(p[: -len("/kernel")]) for p in jtree}
    for path in jtree:
        g = got[_module_key(path[: -len("/kernel")])]
        r = np.asarray(ref[path], np.float32).T
        assert g.dtype == getattr(torch, dtype)
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-6, atol=0, err_msg=path)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126))) - 7)
            assert (np.abs(g.float().numpy() - r) <= ulp).all(), path


def test_merged_context_and_merge_inplace(pair):
    """``merged`` swaps the merged weights in and the same Parameters back
    out; ``merge_`` writes merge's weights; the base is never written."""
    _, params, unet, _ = pair
    u = copy.deepcopy(unet)
    ad = lora_from_jax(jax_adapter(params))
    want = lora.merge(u, ad)
    before = list(u.named_parameters())
    base = {k: v.clone() for k, v in u.state_dict().items()}
    modules = dict(u.named_modules())
    with lora.merged(u, ad):
        assert all(torch.equal(modules[n].weight, w) for n, w in want.items())
    assert [(n, id(p)) for n, p in u.named_parameters()] == [(n, id(p)) for n, p in before]
    assert all(torch.equal(base[k], v) for k, v in u.state_dict().items())
    lora.merge_(u, ad)
    assert all(torch.equal(modules[n].weight, w) for n, w in want.items())
    assert all(torch.equal(base[k], v) for k, v in u.state_dict().items()
               if not any(k == f"{n}.weight" for n in want))


def test_merged_forward_matches_jax(pair):
    """The UNet under ``merged`` against JAX's apply of ``merge``'s tree."""
    junet, params, unet, inputs = pair
    jtree = jax_adapter(params)
    ref = _jax_apply(junet, jlora.merge(params, jtree), inputs)
    with lora.merged(unet, lora_from_jax(jtree)):
        got = _port_apply(unet, inputs)
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.abs(ref - _jax_apply(junet, params, inputs)).max() > 1e-2


def test_adapter_matches_peft(pair):
    """peft 0.19's LoRA (r 4, alpha 4) injected into a copy of the port's
    UNet and loaded with the port's adapter: the same keys as peft's own
    state dict, and peft's unmerged forward equals the port's merged one
    (f32: W x + s·B(A x) against (W + s·B A) x, 1e-5)."""
    peft = pytest.importorskip("peft")
    _, params, unet, inputs = pair
    ad = lora_from_jax(jax_adapter(params))
    pu = peft.inject_adapter_in_model(
        peft.LoraConfig(r=4, lora_alpha=4, target_modules=list(lora.TARGETS)),
        copy.deepcopy(unet))
    sd = {k.removeprefix("unet."): v for k, v in lora_state_dict(ad).items()}
    result = peft.set_peft_model_state_dict(pu, sd)
    assert not result.unexpected_keys
    got = peft.get_peft_model_state_dict(pu)
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    ref = _port_apply(pu, inputs)
    with lora.merged(unet, ad):
        out = _port_apply(unet, inputs)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- attn processors --

def sdpa_proc(q, k, v, *, num_heads, scale, site):
    """Recomputes the default math explicitly."""
    o = dot_product_attention(split_heads(q, num_heads), split_heads(k, num_heads),
                              split_heads(v, num_heads), scale=scale, impl="plain")
    return merge_heads(o)


def values_only_proc(q, k, v, *, num_heads, scale, site):
    """Ignores q and k: the output differs from attention's."""
    return v.mean(dim=-2, keepdim=True).expand(q.shape[:-1] + (v.shape[-1],))


def jax_values_only_proc(q, k, v, *, num_heads, scale, site):
    return jnp.broadcast_to(jnp.mean(v, axis=-2, keepdims=True),
                            q.shape[:-1] + (v.shape[-1],))


@pytest.fixture
def apply(pair):
    _, _, unet, inputs = pair
    yield lambda: _port_apply(unet, inputs)
    AP.set_default_attn_processor()


def test_collect_sites_enumerates_every_attention(apply):
    sites = AP.collect_attn_sites(apply)
    assert len(sites) == 16                 # 4 transformer models x 4 attentions
    assert all(s.rsplit(".", 1)[-1] in ("attn1", "attn2") for s in sites)
    assert [s for s in sites if "temporal_transformer_blocks" not in s]
    assert [s for s in sites if "temporal_transformer_blocks" in s]


def test_sites_match_jax_through_the_key_rule(pair, apply):
    """The same sites in the same first-visit order as the JAX package's."""
    junet, params, _, inputs = pair
    jsites = JAP.collect_attn_sites(lambda: junet.apply({"params": params},
                                                        *map(jnp.asarray, inputs)))
    assert AP.collect_attn_sites(apply) == [_module_key(s) for s in jsites]


def test_explicit_sdpa_processor_matches_default(apply):
    """The default takes the one-token shortcut and the frame attention's own
    path; the processor recomputes full SDPA: f32 reassociation only."""
    base = apply()
    with AP.processors(sdpa_proc):
        swapped = apply()
    np.testing.assert_allclose(swapped, base, atol=2e-5, rtol=2e-5)


def test_custom_processor_changes_output_and_reset_restores(apply):
    base = apply()
    AP.set_attn_processor(values_only_proc)
    changed = apply()
    assert not np.allclose(changed, base, atol=1e-3)
    AP.set_default_attn_processor()
    np.testing.assert_array_equal(apply(), base)


def test_custom_processor_matches_jax(pair, apply):
    """A processor gets the same projections (the frame sites' (B·S, F, C)
    view, the full cross-attention keys) as in the JAX package."""
    junet, params, _, inputs = pair
    with JAP.processors(jax_values_only_proc):
        ref = _jax_apply(junet, params, inputs)
    with AP.processors(values_only_proc):
        got = apply()
    np.testing.assert_allclose(got, ref, **TOL)


def test_per_site_dict_overrides_only_that_site(apply):
    sites = AP.collect_attn_sites(apply)
    base = apply()
    with AP.processors({sites[0]: values_only_proc}):
        out = apply()
    assert not np.allclose(out, base, atol=1e-3)
    with AP.processors({"nonexistent.attn9": values_only_proc}):
        np.testing.assert_array_equal(apply(), base)


def test_dict_validation_against_sites(apply):
    sites = AP.collect_attn_sites(apply)
    with pytest.raises(ValueError):
        AP.set_attn_processor({"bogus": sdpa_proc}, sites=sites)
    with pytest.raises(ValueError):
        AP.set_attn_processor({s: sdpa_proc for s in sites[1:]}, sites=sites)
    AP.set_attn_processor({s: sdpa_proc for s in sites}, sites=sites)
    AP.set_default_attn_processor()


def test_attn_processors_reports_installed(apply):
    sites = AP.collect_attn_sites(apply)
    with AP.processors({sites[0]: values_only_proc}):
        table = AP.attn_processors(apply)
    assert table[sites[0]] is values_only_proc
    assert all(v is None for k, v in table.items() if k != sites[0])
    assert set(table) == set(sites)



def test_processors_hold_in_a_remat_recompute_on_another_thread(pair):
    """remat recomputes the checkpointed blocks in the backward, which for
    CUDA tensors runs on the autograd engine's own thread, and the registry
    is thread-local: each block carries its forward's processors into the
    recompute. Here the backward runs on another thread; a recompute
    without the processor would save other tensors than the forward did."""
    _, _, unet, inputs = pair
    u = copy.deepcopy(unet)
    params = [p for n, p in u.named_parameters() if n.endswith("attn1.to_v.weight")]
    x = [torch.from_numpy(a) for a in inputs]
    out = []
    for remat in ("none", "block"):
        for p in params:
            p.requires_grad_(True)
        with AP.processors(values_only_proc):
            loss = u(*x, remat=remat).square().mean()
        result = {}
        worker = threading.Thread(
            target=lambda: result.update(g=torch.autograd.grad(loss, params)))
        worker.start()
        worker.join(120)
        assert not worker.is_alive() and "g" in result
        out.append((loss.detach(), result["g"]))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-6, atol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
