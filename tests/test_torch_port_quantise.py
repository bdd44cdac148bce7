"""The int8 activation quantisation's redesign on the CPU
(``ops/kernels/int8_quant.py``; the kernel, ``csrc/int8_quant.cu``, runs on
the card only: tests/test_torch_port_cuda.py and chip_smoke.py hold it to
the plain versions tested here).

  - the feed-forward's gate as the quantise's prologue: the plain version
    is the module path (``h * F.gelu(g, approximate="tanh")``, then
    ``quantize_dynamic``) bit for bit in bf16 and f32, and the int8
    feed-forward, which now hands net.2 the projection's output, is the
    module path's bits; against JAX's jitted ``h * nn.gelu(g)`` then
    ``quantize_dynamic`` in f32 the codes agree but at rounding boundaries
    (torch and XLA round the GELU's f32 arithmetic apart: at most one code,
    on at most 0.1 % of values), the scales within 1e-6 relative;
  - one quantisation per self-attention: ``Attention`` and
    ``FrameAxisAttention`` in int8 mode quantise x once for to_q, to_k and
    to_v (one quantise call where there were three), and their outputs are
    bit for bit per-projection ``quant.int8_dense_reference``;
  - ``quantize_plan`` at every int8 site of the site tables and, with
    hypothesis, at any shape: every row in exactly one block's share, the
    shared memory within a Hopper block's 232,448 bytes;
  - a row-parallel net.2 with the gate prologue over two gloo ranks is the
    one-rank product bit for bit in float64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from svd_xtend_tpu.ops import quant as jq
from svd_xtend_tpu_torch.models import transformer as tt
from svd_xtend_tpu_torch.ops import quant
from svd_xtend_tpu_torch.ops.kernels import int8_gemm as ig
from svd_xtend_tpu_torch.ops.kernels import int8_quant as iq
from svd_xtend_tpu_torch.ops.kernels import temporal_attention as tak
from svd_xtend_tpu_torch.ops.attention import dot_product_attention_packed
from svd_xtend_tpu_torch.scripts import sites

from test_torch_port_frames import Pool

torch.set_num_threads(1)

SMEM_LIMIT = 232448     # a Hopper block's dynamic shared memory
H100_SMS = 132


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# ------------------------------------------------------------ the gate --

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gate_plain_version_is_the_module_path(dtype):
    """quantize_reference(y, gate=True) is h·gelu_tanh(g) then
    quantize_dynamic, bit for bit; the CPU wrapper takes it."""
    y = torch.from_numpy(_rand(1, 37, 2 * 48, scale=2.0)).to(dtype)
    h, g = y.chunk(2, dim=-1)
    v = h * F.gelu(g, approximate="tanh")
    codes, scale = quant.quantize_dynamic(v)
    got, stats = iq.quantize_reference(y, gate=True)
    assert got.dtype == torch.int8 and got.shape == (37, 48)
    assert torch.equal(got, codes)
    assert torch.equal(stats, torch.stack([v.float().abs().amax(), scale]))
    assert torch.equal(iq.gate_reference(y), v)
    for a, b in zip(iq.quantize(y, gate=True), (got, stats)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_feed_forward_hands_net2_the_gate(dtype, monkeypatch):
    """In int8 mode FeedForward passes net.0.proj's output to net.2 with the
    gate, and gives the module path's bits (the product built, then
    quantised); outside int8 mode it is unchanged."""
    g = torch.Generator().manual_seed(3)
    ff = tt.FeedForward(32).to(dtype)
    with torch.no_grad():
        for p in ff.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    x = torch.randn(2, 9, 32, generator=g).to(dtype)
    seen = []
    site = ig.linear_site

    def spy(x, weight, bias=None, group=None, **kw):
        seen.append((x.shape[-1], weight.shape[1], bool(kw.get("gate"))))
        return site(x, weight, bias, group, **kw)

    monkeypatch.setattr(ig, "linear_site", spy)
    with torch.no_grad(), quant.quantized("int8"):
        got = ff(x)
        h, gate = ff.net[0].proj(x).chunk(2, dim=-1)
        ref = ff.net[2](h * F.gelu(gate, approximate="tanh"))
    assert seen[:2] == [(32, 32, False), (256, 128, True)]
    assert torch.equal(got, ref)
    with torch.no_grad():
        h, gate = ff.net[0].proj(x).chunk(2, dim=-1)
        assert torch.equal(ff(x), ff.net[2](h * F.gelu(gate, approximate="tanh")))


@pytest.mark.parametrize("seed,scale", [(4, 1.0), (5, 3.0), (6, 0.05)])
def test_gate_quantise_against_jitted_jax(seed, scale):
    """f32: the port's gate quantise against JAX's jitted h * nn.gelu(g)
    (tanh form) then quantize_dynamic: codes at most one apart, on at most
    0.1 % of values (a product at a rounding boundary); scale within 1e-6
    relative."""
    y = _rand(seed, 64, 2 * 320, scale=scale)
    h, g = np.split(y, 2, axis=-1)
    jf = jax.jit(lambda h, g: jq.quantize_dynamic(h * nn.gelu(g)))
    jcodes, jscale = (np.asarray(a) for a in jf(jnp.asarray(h), jnp.asarray(g)))
    codes, stats = iq.quantize_reference(torch.from_numpy(y), gate=True)
    diff = np.abs(codes.numpy().astype(np.int32) - jcodes.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    assert abs(stats[1].item() - float(jscale)) <= 1e-6 * float(jscale)


# ------------------------------------------- one quantisation per x --

def _count_quantise(monkeypatch):
    calls = []
    quantize = iq.quantize

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return quantize(*a, **kw)

    monkeypatch.setattr(iq, "quantize", counted)
    return calls


def _seeded(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return module


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_self_attention_quantises_x_once(dtype, monkeypatch):
    """Attention in int8 mode: one quantise call for to_q, to_k and to_v (and
    one for to_out), four dense sites; the output is per-projection
    int8_dense_reference's bit for bit. Cross-attention quantises its
    context apart."""
    attn = _seeded(tt.Attention(32, 2, 16), 7).to(dtype)
    x = torch.randn(2, 10, 32, generator=torch.Generator().manual_seed(8)).to(dtype)
    calls = _count_quantise(monkeypatch)
    with torch.no_grad(), quant.quantized("int8"):
        got = attn(x)
    assert len(calls) == 2
    ref_dense = quant.int8_dense_reference
    with torch.no_grad():
        q, k, v = (ref_dense(x, p.weight) for p in (attn.to_q, attn.to_k, attn.to_v))
        o = dot_product_attention_packed(q, k, v, num_heads=2, scale=16 ** -0.5)
        ref = ref_dense(o, attn.to_out[0].weight, attn.to_out[0].bias)
    assert torch.equal(got, ref)
    cross = _seeded(tt.Attention(32, 2, 16, context_dim=24), 9).to(dtype)
    ctx = torch.randn(2, 3, 24, generator=torch.Generator().manual_seed(10)).to(dtype)
    calls.clear()
    with torch.no_grad(), quant.quantized("int8"):
        cross(x, ctx)
    assert len(calls) == 4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_frame_attention_quantises_x_once(dtype, monkeypatch):
    """FrameAxisAttention in int8 mode: one quantise call for q, k, v; the
    output is per-projection int8_dense_reference's bit for bit."""
    attn = _seeded(tt.FrameAxisAttention(32, 2, 16), 11).to(dtype)
    x = torch.randn(2, 3, 5, 32, generator=torch.Generator().manual_seed(12)).to(dtype)
    calls = _count_quantise(monkeypatch)
    with torch.no_grad(), quant.quantized("int8"):
        got = attn(x)
    assert len(calls) == 2
    ref_dense = quant.int8_dense_reference
    with torch.no_grad():
        q, k, v = (ref_dense(x, p.weight) for p in (attn.to_q, attn.to_k, attn.to_v))
        o = tak.frame_attention_reference(q, k, v, num_heads=2, scale=16 ** -0.5)
        ref = ref_dense(o, attn.to_out[0].weight, attn.to_out[0].bias)
    assert torch.equal(got, ref)


def test_self_attention_processor_path_quantises_x_once(monkeypatch):
    """With an attention processor installed, the self-attention's q, k, v
    still come from one quantisation, and equal the three projections'."""
    from svd_xtend_tpu_torch.models import attn_processor
    attn = _seeded(tt.Attention(32, 2, 16), 13)
    attn.site = "probe"
    x = torch.randn(2, 6, 32, generator=torch.Generator().manual_seed(14))
    seen = {}

    def proc(q, k, v, **kw):
        seen.update(q=q, k=k, v=v)
        return q

    calls = _count_quantise(monkeypatch)
    with torch.no_grad(), quant.quantized("int8"), attn_processor.processors({"probe": proc}):
        attn(x)
    assert len(calls) == 2
    for name, p in (("q", attn.to_q), ("k", attn.to_k), ("v", attn.to_v)):
        assert torch.equal(seen[name], quant.int8_dense_reference(x, p.weight))


def test_empty_part_quantises_to_nothing():
    """A model rank without a head (or without feed-forward columns) has an
    empty (..., 0) part at its row-parallel QLinear (and an empty gate):
    its codes are empty and its amax 0 (the row-parallel product over such
    a rank: test_row_parallel_gate_is_the_one_rank_product, and the model
    tests' rank without a head)."""
    for x, gate in ((torch.zeros(2, 3, 0), False), (torch.zeros(2, 3, 0), True),
                    (torch.zeros(0, 5, 8), False)):
        codes, stats = ig.linear_codes(x, gate)
        assert codes.shape == (x.shape[:-1].numel(), x.shape[-1] // (2 if gate else 1))
        assert stats[0].item() == 0.0


# --------------------------------------------------------- the plan --

def _check_plan(plan, m, widths, gate=False, rows_per_sample=None, sms=H100_SMS,
                phased=False):
    """The invariants the kernel's C entry checks and relies on."""
    row_bytes = 2 * sum(widths)
    parts = (widths[0] // 2,) if gate else widths
    assert plan.tile_rows >= 1 and plan.slot_bytes % 128 == 0
    assert plan.slot_bytes >= plan.tile_rows * row_bytes
    if rows_per_sample is not None:
        assert plan.tile_rows <= rows_per_sample    # a tile spans at most two samples
    assert plan.tiles == -(-m // plan.tile_rows)
    assert 1 <= plan.grid <= min(sms, iq.MAX_BLOCKS)
    assert (plan.grid - 1) * plan.share < plan.tiles <= plan.grid * plan.share
    # every row in exactly one share, in order, no block empty
    covered = 0
    for b in range(plan.grid):
        t0, t1 = b * plan.share, min((b + 1) * plan.share, plan.tiles)
        assert t1 > t0
        assert t0 * plan.tile_rows == covered
        covered = min(t1 * plan.tile_rows, m)
    assert covered == m
    assert 1 <= plan.slots <= min(iq.MAX_SLOTS, plan.share)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.vec == (8 if all(w % 8 == 0 for w in parts) else 4)
    assert not plan.tma or plan.vec == 8
    budget = iq.MAX_SMEM - iq.HEADER - (iq.LUT_BYTES if gate else 0)
    if (not phased and m * row_bytes <= iq.TINY_BYTES and plan.tiles <= iq.MAX_SLOTS
            and plan.tiles * plan.slot_bytes <= budget):
        # a tiny call: one block keeps it all, no grid barrier
        assert plan.grid == 1 and plan.kept_tiles == plan.tiles
    assert 0 <= plan.kept_tiles <= plan.tiles


def _split_of(h, w, ci, co):
    for sh, sw, c1, c2, sco in sites.UP_SPLIT_SITES:
        if (sh, sw, c1 + c2, sco) == (h, w, ci, co):
            return c1, c2
    return None


_CONV = [(28,) + st[:5] for st in sites.INT8_CONV_SITES] + \
        [(8,) + st[:5] for st in sites.INT8_VAE_CONV_SITES]


@pytest.mark.parametrize("site", _CONV, ids=lambda st: "-".join(map(str, st)))
def test_quantize_plan_at_conv_sites(site):
    n, h, w, ci, co, epi = site
    split = _split_of(h, w, ci, co) if "post" in epi else None
    widths = split or (ci,)
    rps = h * w if epi.startswith("pre") else None
    for phased in (False, True):
        plan = iq.quantize_plan(n * h * w, widths, False, rps, H100_SMS, phased)
        _check_plan(plan, n * h * w, widths, False, rps, H100_SMS, phased)
        # the bulk copies wherever the widths allow them (not the VAE's Ci 4)
        assert plan.tma == all(c % 8 == 0 for c in widths)
        again = plan.tiles if phased else plan.streamed_tiles
        assert plan.keep_l2 == (0 < again * plan.tile_rows * 2 * ci <= iq.L2_KEEP)


@pytest.mark.parametrize("site", sites.INT8_DENSE_SITES, ids=lambda st: "-".join(map(str, st)))
def test_quantize_plan_at_dense_sites(site):
    rows, k = site[:2]
    for phased in (False, True):
        plan = iq.quantize_plan(rows, (k,), sms=H100_SMS, phased=phased)
        _check_plan(plan, rows, (k,), sms=H100_SMS, phased=phased)
    if rows <= 28:      # the CLIP token's rows: one block, no barrier
        assert iq.quantize_plan(rows, (k,), sms=H100_SMS).grid == 1


@pytest.mark.parametrize("site", sites.INT8_GATE_SITES, ids=lambda st: "-".join(map(str, st)))
def test_quantize_plan_at_gate_sites(site):
    rows, k2, k = site[:3]
    assert k2 == 2 * k
    for phased in (False, True):
        plan = iq.quantize_plan(rows, (k2,), True, sms=H100_SMS, phased=phased)
        _check_plan(plan, rows, (k2,), True, sms=H100_SMS, phased=phased)
        assert plan.smem_bytes >= iq.HEADER + iq.LUT_BYTES


def test_gate_sites_are_the_feed_forwards_second_projections():
    """Every (R, 4C, C) QLinear site is net.2 and has its gate site (R, 8C,
    4C): 48 a CFG pass; 302 quantise calls a pass, the same cond-only."""
    net2 = {st[:3]: st[3] for st in sites.INT8_DENSE_SITES if st[1] == 4 * st[2]}
    assert {(r, 2 * k, k): n for (r, k, _), n in net2.items()} == {
        st[:3]: st[3] for st in sites.INT8_GATE_SITES}
    assert sum(st[3] for st in sites.INT8_GATE_SITES) == 48
    assert sites.int8_quantize_calls(batch=1) == sites.INT8_QUANTIZE_CALLS == 302


_widths = st.integers(1, 640).map(lambda k: 4 * k)


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(m=st.integers(1, 3_000_000), w1=_widths, w2=st.one_of(st.none(), _widths),
       gate=st.booleans(), rps=st.one_of(st.none(), st.integers(1, 5000)),
       sms=st.integers(1, 160), phased=st.booleans(), aligned=st.booleans())
def test_quantize_plan_any_shape(m, w1, w2, gate, rps, sms, phased, aligned):
    widths = (2 * w1,) if gate else ((w1,) if w2 is None else (w1, w2))
    try:
        plan = iq.quantize_plan(m, widths, gate, None if gate else rps, sms, phased, aligned)
    except ValueError:
        # refused only where two rows do not fit a block's slots
        budget = iq.MAX_SMEM - iq.HEADER - (iq.LUT_BYTES if gate else 0)
        assert 2 * (-(-2 * sum(widths) // 128) * 128) > budget
        return
    _check_plan(plan, m, widths, gate, None if gate else rps, sms, phased)
    assert plan.tma == (aligned and plan.vec == 8)


# ------------------------------------------- a row-parallel net.2 --

def job_row_parallel_gate(world, y, weight, bias):
    """This rank's columns of net.2 (RowParallelLinear) with the gate
    prologue on its columns of net.0.proj's output, in int8 mode with the
    amax over the group."""
    import torch.distributed as dist

    from svd_xtend_tpu_torch.parallel.tensor import TensorShard, ff_split
    n, r = world.size, world.rank
    sizes = ff_split(weight.shape[1], n)
    a, b = sum(sizes[:r]), sum(sizes[:r + 1])
    h, g = y.chunk(2, dim=-1)
    lin = tt.RowParallelLinear(b - a, weight.shape[0],
                               TensorShard(dist.group.WORLD, tuple(range(n)), r)).double()
    with torch.no_grad():
        lin.weight.copy_(weight[:, a:b])
        lin.bias.copy_(bias)
        with quant.quantized("int8", dist.group.WORLD):
            return lin(torch.cat([h[..., a:b], g[..., a:b]], dim=-1), gate=True)


JOBS = {"row_parallel_gate": job_row_parallel_gate}


@pytest.fixture(scope="module")
def two():
    pool = Pool(2, JOBS)
    yield pool
    pool.close()


def test_row_parallel_gate_is_the_one_rank_product(two):
    """float64: two ranks' row-parallel net.2 with the gate prologue (each
    its columns of h and g, the amax and the int32 sums over the group)
    equals one rank's QLinear on the whole projection, bit for bit."""
    rng = np.random.default_rng(15)
    inner, c = 128, 32
    y = torch.from_numpy(rng.standard_normal((2, 7, 2 * inner)) * 1.5)
    weight = torch.from_numpy(rng.standard_normal((c, inner)) * inner ** -0.5)
    bias = torch.from_numpy(rng.standard_normal(c) * 0.1)
    two.submit("row_parallel_gate", y, weight, bias)
    one = tt.QLinear(inner, c).double()
    with torch.no_grad():
        one.weight.copy_(weight)
        one.bias.copy_(bias)
        with quant.quantized("int8"):
            want = one(y, gate=True)
            h, g = y.chunk(2, dim=-1)
            assert torch.equal(want, one(h * F.gelu(g, approximate="tanh")))
    got = two.collect("row_parallel_gate")
    assert torch.equal(got[0], want) and torch.equal(got[1], want)


def test_plan_dataclass_is_frozen():
    plan = iq.quantize_plan(71680, (320,), sms=H100_SMS)
    with pytest.raises(dataclasses.FrozenInstanceError):
        plan.grid = 1
