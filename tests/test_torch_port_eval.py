"""The port's evaluation entry points (``svd_xtend_tpu_torch/scripts/
eval_approx.py``, ``eval_tracklet.py``) against the JAX package's
``scripts/eval_approx.py`` and ``scripts/eval_tracklet.py``, imported by
file path, on the CPU at the TINY / ``--smoke`` sizes in f32:

- eval_tracklet's synthetic lanes, frames and data folders bit for bit;
  ``adherence`` on the same seeded videos to 1e-6;
- eval_approx's generate phase at ``--smoke``, given the JAX script's
  weights, image and noise: its exact and k3 videos at the pipeline tests'
  tolerance; its metrics phase over the JAX script's saved videos, on the
  JAX CLIP tower converted by ``state_dict_from_jax``: PSNR to 1e-3 dB,
  the CLIP cosine and the report metrics to 1e-4 (both scripts' rounding
  taken out);
- the denoiser probe on converted TINY tracklet weights, with the JAX
  script's draws, against the JAX script's probe: the MSEs to 1e-5 and the
  steer margins' signs;
- ``eval_tracklet --device cpu --steps 2 --infer_steps 2`` end to end: the
  JAX script's JSON schema, and a run directory that the JAX script's
  ``load_models_and_params`` reads with the same gate alphas;
- a failing mode ends ``eval_approx`` with its error; without a card
  ``--device cuda`` raises; the three bf16-only kernel sites route another
  dtype on the card to their plain versions (F8).
"""

import argparse
import copy
import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svd_xtend_tpu.core import config as jcfg
from svd_xtend_tpu.diffusion import pipeline as jpipe
from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.diffusion import pipeline as tpipe
from svd_xtend_tpu_torch.diffusion import training as ttrain
from svd_xtend_tpu_torch.io.convert import state_dict_from_jax
from svd_xtend_tpu_torch.ops.kernels.dispatch import bf16_site, plain_versions
from svd_xtend_tpu_torch.scripts import eval_approx as tea
from svd_xtend_tpu_torch.scripts import eval_tracklet as tet
from test_torch_port_pipeline import _jax_noise
from test_torch_port_probes import _load_script

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = tet.TRAIN_KINDS + tet.HELD_OUT
MODES = ("exact", "cfg_cache_k3")
DIM = 64                       # the JAX script's default --dim


def _unrounded(monkeypatch, *modules):
    """Both scripts round what they report; compare the values themselves."""
    for mod in modules:
        monkeypatch.setattr(mod, "round", lambda v, n=None: v, raising=False)


@pytest.fixture(scope="module")
def jea():
    return _load_script("eval_approx")


@pytest.fixture(scope="module")
def jet():
    return _load_script("eval_tracklet")


@pytest.fixture(scope="module")
def nets():
    """One JAX init of the TINY pipeline with the Tracklet2Video branch at
    the JAX script's --dim, the networks of its ``load_models_and_params``
    (a cache hit for that loader's own init), and the same weights without
    the branch for eval_approx's smoke networks; the port's counterparts.
    {"jax": (models, params), "jax_tracklet": ..., "port": models,
    "port_tracklet": models}."""
    def tiny():
        return jpipe.SVDModels(unet_config=jcfg.TINY_UNET, vae_config=jcfg.TINY_VAE,
                               clip_config=jcfg.TINY_CLIP, dtype=jnp.float32)

    jm_t = tiny().with_tracklet(DIM)
    params_t = jpipe.init_pipeline_params(jm_t, jax.random.PRNGKey(0))
    flat_t = jconv.flatten(params_t)
    flat = {k: v for k, v in flat_t.items()
            if not (k.startswith("unet/") and jconv._is_extension_path(k[len("unet/"):]))}
    out = {"jax": (tiny(), jconv.unflatten(flat)), "jax_tracklet": (jm_t, params_t)}
    for key, f in (("port", flat), ("port_tracklet", flat_t)):
        tm = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP, device="cpu")
        if key == "port_tracklet":
            tm = tm.with_tracklet(DIM)
        sds = state_dict_from_jax(f)
        for name in ("unet", "vae", "clip"):
            getattr(tm, name).load_state_dict(sds[name], strict=True)
        out[key] = tm
    return out


# ------------------------------------------------------ eval_tracklet data --

def test_constants_and_lanes_match_jax(jet):
    assert (tet.H, tet.W, tet.SQ, tet.FRAMES) == (jet.H, jet.W, jet.SQ, jet.FRAMES)
    assert sorted(LANES) == ["antidiag", "diag", "down", "left", "right", "up"]


@pytest.mark.parametrize("kind", LANES)
def test_lanes_and_frames_match_jax(jet, kind):
    boxes = tet._traj_boxes(kind)
    assert boxes.dtype == np.float32 and np.array_equal(boxes, jet._traj_boxes(kind))
    for seed in (0, 5):
        got = tet._render(boxes, np.random.RandomState(seed))
        assert np.array_equal(got, jet._render(boxes, np.random.RandomState(seed)))


def test_build_dataset_matches_jax(jet, tmp_path):
    """Every lane's JPEG frames byte for byte and its boxes.npz array."""
    tet.build_dataset(str(tmp_path / "port"), LANES)
    jet.build_dataset(str(tmp_path / "jax"), LANES)
    for kind in LANES:
        d_t, d_j = (tmp_path / side / f"video_{kind}" for side in ("port", "jax"))
        assert sorted(os.listdir(d_t)) == sorted(os.listdir(d_j))
        for f in range(tet.FRAMES):
            name = f"{f:04d}.jpg"
            assert (d_t / name).read_bytes() == (d_j / name).read_bytes(), (kind, name)
        b_t, b_j = np.load(d_t / "boxes.npz")["boxes"], np.load(d_j / "boxes.npz")["boxes"]
        assert b_t.shape == (tet.FRAMES, 1, 4) and np.array_equal(b_t, b_j)


@pytest.mark.parametrize("kind", LANES)
def test_adherence_matches_jax(jet, kind):
    """On a video drifting toward the lane's square and on noise."""
    rs = np.random.RandomState(LANES.index(kind))
    lane = tet._lane_video(kind)
    noisy = np.clip(lane + 0.3 * rs.randn(*lane.shape), -1, 1).astype(np.float32)
    for video in (noisy, rs.uniform(-1, 1, lane.shape).astype(np.float32)):
        for boxes in (tet._traj_boxes(kind), tet._traj_boxes(tet.WRONG[kind])):
            np.testing.assert_allclose(tet.adherence(video, boxes),
                                       jet.adherence(video, boxes), rtol=0, atol=1e-6)


# ---------------------------------------------------------- eval_approx --

def _jax_args(vdir, out=None):
    return argparse.Namespace(phase="all", videos=str(vdir), height=320, width=512,
                              frames=14, steps=25, iters=1, smoke=True,
                              only="cfg_cache_k3", out=out)


def _port_argv(vdir, *extra):
    return ["--smoke", "--only", "cfg_cache_k3", "--iters", "1", "--device", "cpu",
            "--videos", str(vdir), *extra]


@pytest.fixture(scope="module")
def approx_runs(jea, nets, tmp_path_factory):
    """The JAX script's generate phase at --smoke (exact and k3) on the
    branch-free weights of ``nets`` (its init_pipeline_params handing them
    over), then the port's on the same weights, the JAX script's saved
    image and its generation key's noise."""
    tm = nets["port"]
    jdir, tdir = tmp_path_factory.mktemp("jax_videos"), tmp_path_factory.mktemp("port_videos")
    mp = pytest.MonkeyPatch()
    mp.setattr(jpipe, "init_pipeline_params", lambda models, rng, **_: nets["jax"][1])
    try:
        jea.phase_generate(_jax_args(jdir), str(jdir))
    finally:
        mp.undo()
    image = np.load(jdir / "cond_image.npy")
    h8 = 32 // jcfg.TINY_VAE.downsample_factor
    noise = _jax_noise(jax.random.PRNGKey(111), image.shape, (1, 2, h8, h8, 4))
    assert tea.main(_port_argv(tdir, "--phase", "generate"), models=tm,
                    image=torch.from_numpy(image),
                    noise=tuple(torch.from_numpy(n) for n in noise)) is None
    return jdir, tdir


@pytest.mark.parametrize("mode", MODES)
def test_generate_phase_matches_jax(approx_runs, mode):
    jdir, tdir = approx_runs
    ref, got = np.load(jdir / f"{mode}.npy"), np.load(tdir / f"{mode}.npy")
    assert got.shape == ref.shape == (1, 2, 32, 32, 3) and np.isfinite(got).all()
    # the exact path's tolerance (test_torch_port_pipeline.py): f32 throughout,
    # XLA and torch differ only in summation order
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)
    with open(tdir / "timings.json") as f:
        assert sorted(json.load(f)[mode]) == ["frames_per_sec", "s_per_video"]


@pytest.fixture(scope="module")
def metrics_tables(jea, nets, approx_runs, tmp_path_factory):
    """Both metrics phases over the JAX script's saved videos; the port's on
    the CLIP tower the JAX script initialises (split(PRNGKey(0), 3)[2])."""
    tm = nets["port"]
    jdir, _ = approx_runs
    out = tmp_path_factory.mktemp("tables")
    mp = pytest.MonkeyPatch()
    _unrounded(mp, jea, tea)
    try:
        jea.phase_metrics(_jax_args(jdir, str(out / "jax.json")), str(jdir))
        c = jcfg.TINY_CLIP
        k3 = jax.random.split(jax.random.PRNGKey(0), 3)[2]
        clip_params = jpipe.SVDModels(clip_config=c, dtype=jnp.float32).clip().init(
            k3, jnp.zeros((1, c.image_size, c.image_size, 3)))["params"]
        sd = state_dict_from_jax({f"clip/{k}": v
                                  for k, v in jconv.flatten(clip_params).items()})
        clip = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP,
                                      device="cpu").clip
        clip.load_state_dict(sd["clip"], strict=True)
        got = tea.phase_metrics(tea.parse_args(_port_argv(jdir, "--out",
                                                          str(out / "port.json"))),
                                str(jdir), models=dataclasses.replace(tm, clip=clip))
    finally:
        mp.undo()
    with open(out / "jax.json") as f:
        want = json.load(f)
    with open(out / "port.json") as f:
        assert json.load(f) == got
    return got, want


@pytest.mark.parametrize("mode", MODES)
def test_metrics_phase_matches_jax(metrics_tables, mode):
    got, want = metrics_tables
    assert got["operating_point"] == want["operating_point"] == "32x32x2f 3st"
    assert list(got["modes"]) == list(want["modes"]) == list(MODES)
    row, ref = got["modes"][mode], want["modes"][mode]
    assert sorted(row) == sorted(ref)
    report = ("clip_sim_mean", "clip_sim_last", "temporal_consistency", "flicker")
    expect = report if mode == "exact" else (
        "psnr_vs_exact_db", "clip_cos_vs_exact", "max_abs_err") + report
    assert set(expect) <= set(row)
    for k in expect:
        tol = 1e-3 if k == "psnr_vs_exact_db" else 1e-4
        assert abs(row[k] - ref[k]) <= tol, (k, row[k], ref[k])


def test_a_failing_mode_ends_the_run(monkeypatch, tmp_path):
    """No mode is skipped: the error of the k3 mode leaves main, after the
    exact mode's video and timing were written."""
    models = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP,
                                    device="cpu", generator=torch.Generator().manual_seed(0))
    real = tea.generate

    def generate(models, image, cfg, **kw):
        if cfg.uncond_reuse_interval == 3:
            raise RuntimeError("mode failed")
        return real(models, image, cfg, **kw)

    monkeypatch.setattr(tea, "generate", generate)
    with pytest.raises(RuntimeError, match="mode failed"):
        tea.main(_port_argv(tmp_path, "--out", str(tmp_path / "t.json")), models=models)
    with open(tmp_path / "timings.json") as f:
        assert list(json.load(f)) == ["exact"]
    assert (tmp_path / "exact.npy").exists() and not (tmp_path / "t.json").exists()


def test_smoke_without_only_is_refused_before_any_video(tmp_path):
    """The TINY UNet has two levels: deep_n2_d2 cannot run, and the run says
    so before generating anything."""
    models = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP,
                                    device="cpu")
    with pytest.raises(ValueError, match="deep_n2_d2"):
        tea.main(["--smoke", "--device", "cpu", "--videos", str(tmp_path)], models=models)
    assert not os.listdir(tmp_path)


def test_modes_match_jax(jea):
    """The twelve modes by name and configuration."""
    models = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP,
                                    device="cpu")
    got = tea.build(tea.parse_args(["--smoke", "--device", "cpu"]), models)[3]
    want = jea.build(argparse.Namespace(smoke=True, only=None))[3]
    assert [n for n, _ in got] == [n for n, _ in want] and len(got) == 12
    for (name, t), (_, j) in zip(got, want):
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name


@pytest.mark.parametrize("script", ["eval_approx", "eval_tracklet"])
def test_device_cuda_without_a_card_raises(monkeypatch, tmp_path, script):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"eval_approx": tea, "eval_tracklet": tet}[script]
    argv = {"eval_approx": ["--smoke", "--only", "cfg_cache_k3", "--videos", str(tmp_path)],
            "eval_tracklet": ["--steps", "2", "--workdir", str(tmp_path)]}[script]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main(argv)
    assert not os.listdir(tmp_path)


# ---------------------------------------------------- the denoiser probe --

def _encode_draws(key, pixel_shape, cfg) -> ttrain.TrainDraws:
    """The draws of the JAX package's ``encode_batch(..., key, cfg)``
    (training.py:51, :71, :84-90); the loss's draws, unread, zero."""
    b, f, h, w, _ = pixel_shape
    ds = jcfg.TINY_VAE.downsample_factor
    lat = (h // ds, w // ds, jcfg.TINY_VAE.latent_channels)
    from svd_xtend_tpu.core import edm as jedm
    k_lat, k_aug, k_cond = jax.random.split(key, 3)
    bf = b * f
    cap = min(cfg.encode_chunk_size or bf, bf)
    n_full, rem = bf // cap, bf % cap
    keys = jax.random.split(k_lat, n_full + 1)
    parts = [jax.random.normal(keys[i], (cap,) + lat, jnp.float32) for i in range(n_full)]
    if rem:
        parts.append(jax.random.normal(keys[n_full], (rem,) + lat, jnp.float32))
    t = lambda a: torch.from_numpy(np.array(a))
    return ttrain.TrainDraws(
        latent_noise=t(jnp.concatenate(parts)),
        cond_sigma=t(jedm.rand_log_normal(k_aug, (b,), cfg.cond_aug_loc, cfg.cond_aug_std)),
        cond_pixel_noise=t(jax.random.normal(k_cond, (b, h, w, 3), jnp.float32)),
        cond_latent_noise=t(jax.random.normal(jax.random.fold_in(k_cond, 1), (b,) + lat,
                                              jnp.float32)),
        dropout_u=torch.zeros(b), sigma=torch.zeros(b), noise=torch.zeros(b, f, *lat))


def _jax_probe(jet, models, params, lanes, mode, dim):
    """The JAX script's denoiser probe (eval_tracklet.py:340-395) on the
    given networks, its encodes and UNet jitted; unrounded."""
    from svd_xtend_tpu.core import edm
    from svd_xtend_tpu.core.config import TrainConfig
    from svd_xtend_tpu.diffusion.pipeline import get_add_time_ids
    from svd_xtend_tpu.diffusion.training import encode_batch
    tcfg_ = TrainConfig(train_mode=mode, tracklet_dim=dim, max_boxes=1,
                        conditioning_dropout_prob=0.0)
    vids = {k: jnp.asarray(jet._render(jet._traj_boxes(k), np.random.RandomState(0))
                           .astype(np.float32)[None] / 127.5 - 1.0) for k in lanes}
    encode = jax.jit(encode_batch, static_argnums=(0, 4))
    enc = {k: encode(models, params, vids[k], jax.random.PRNGKey(9), tcfg_) for k in lanes}
    unet = models.unet()
    apply = jax.jit(lambda p, *a: unet.apply({"params": p}, *a))
    probe = {}
    for s in (2.0, 8.0):
        sigma = jnp.asarray([s])
        sig_b = sigma.reshape(1, 1, 1, 1, 1)
        for src in lanes:
            e = enc[src]
            noise = jax.random.normal(jax.random.PRNGKey(10), e.latents.shape)
            noisy = e.latents + noise * sig_b
            model_in = edm.precondition_inputs(noisy, sig_b)
            cond = jnp.broadcast_to(e.cond_latents[:, None],
                                    e.latents.shape[:4] + (e.cond_latents.shape[-1],))
            model_in = jnp.concatenate([model_in, cond], axis=-1)
            add_ids = get_add_time_ids(7.0, 127.0, e.noise_aug, 1)
            row = {}
            for cond_lane in lanes:
                bxp = jnp.asarray(jet._traj_boxes(cond_lane))[None, :, None, :]
                pred = apply(params["unet"], model_in.astype(models.dtype),
                             edm.sigma_to_t(sigma), e.image_embeds.astype(models.dtype),
                             add_ids, bxp, jnp.ones((1, jet.FRAMES, 1), jnp.float32))
                den = edm.denoise(pred.astype(jnp.float32), noisy, sig_b)
                row[cond_lane] = {k2: float(jnp.mean((den - enc[k2].latents) ** 2))
                                  for k2 in lanes}
            probe[f"noisy_{src}@s{s:g}"] = row
        m = 0.0
        for src in lanes:
            row = probe[f"noisy_{src}@s{s:g}"]
            for cl in lanes:
                other = [k2 for k2 in lanes if k2 != cl][0]
                m += row[cl][other] - row[cl][cl]
        probe[f"steer_margin@s{s:g}"] = m / (len(lanes) ** 2)
    return probe, np.array(noise)


@pytest.fixture(scope="module")
def probes(jet, nets):
    """The JAX script's probe and the port's on the TINY tracklet weights
    of ``nets`` with the gates opened to 0.5 (so that the branch acts), the
    port fed the JAX draws."""
    lanes = ("right", "left")
    jm, params = nets["jax_tracklet"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.full_like(v, 0.5) if "alpha_" in jax.tree_util.keystr(path) else v,
        params)
    want, noise = _jax_probe(jet, jm, params, lanes, "full", DIM)
    tm = dataclasses.replace(nets["port_tracklet"], unet=copy.deepcopy(
        nets["port_tracklet"].unet))
    tm.unet.load_state_dict(state_dict_from_jax(
        {f"unet/{k}": v for k, v in jconv.flatten(params["unet"]).items()})["unet"],
        strict=True)
    draws = _encode_draws(jax.random.PRNGKey(9), (1, tet.FRAMES, tet.H, tet.W, 3),
                          jcfg.TrainConfig())
    mp = pytest.MonkeyPatch()
    _unrounded(mp, tet)
    try:
        got = tet.denoiser_probe(tm, lanes, "full", DIM, draws=draws,
                                 noise=torch.from_numpy(noise))
    finally:
        mp.undo()
    return got, want


@pytest.mark.parametrize("sigma", ["2", "8"])
def test_denoiser_probe_matches_jax(probes, sigma):
    got, want = probes
    assert sorted(got) == sorted(list(want) + ["steer_margin"])
    for src in ("right", "left"):
        key = f"noisy_{src}@s{sigma}"
        for cl, row in want[key].items():
            for k2, v in row.items():
                assert abs(got[key][cl][k2] - v) <= 1e-5, (key, cl, k2, got[key][cl][k2], v)
    margin = f"steer_margin@s{sigma}"
    assert abs(got[margin] - want[margin]) <= 1e-5
    assert np.sign(got[margin]) == np.sign(want[margin]) != 0
    assert got["steer_margin"] == got["steer_margin@s8"]


# ------------------------------------------------- eval_tracklet end to end --

def _schema(obj):
    """The nested key structure of a JSON value."""
    if isinstance(obj, dict):
        return {k: _schema(v) for k, v in obj.items()}
    return type(obj).__name__ if not isinstance(obj, (int, float)) or isinstance(
        obj, bool) else "number"


def test_eval_tracklet_end_to_end_reads_back_in_jax(jet, nets, tmp_path, capsys):
    """Two training steps and two-step generations on the CPU: the JAX
    script's summary schema (its record of the current schema,
    eval_tracklet_r5_twophase.json), and
    the run directory read by the JAX script's loader with the same gate
    alphas."""
    out = tmp_path / "out.json"
    got = tet.main(["--device", "cpu", "--steps", "2", "--infer_steps", "2",
                    "--workdir", str(tmp_path / "w"), "--out", str(out)])
    port_log = capsys.readouterr().out
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(got))
    with open(os.path.join(REPO, "eval_tracklet_r5_twophase.json")) as f:
        record = json.load(f)
    assert _schema(got) == _schema(record)
    assert got["summary"]["steps"] == 2 and got["summary"]["dim"] == DIM
    run = str(tmp_path / "w" / "run")
    assert sorted(os.listdir(tmp_path / "w" / "data")) == [f"video_{k}" for k in
                                                            sorted(tet.TRAIN_KINDS)]
    jet.load_models_and_params(run, DIM)
    jax_log = capsys.readouterr().out
    gate = lambda log: [ln for ln in log.splitlines() if ln.startswith("gate alphas:")]
    assert len(gate(port_log)) == 1 and gate(port_log) == gate(jax_log)
    _, gates = tet.load_models_and_params(run, DIM, "cpu")
    assert gates and all(np.isfinite(list(gates.values())))


# -------------------------------------------------------------------- F8 --

@pytest.mark.parametrize("cuda,dtype,takes", [(True, torch.bfloat16, True),
                                              (True, torch.float32, False),
                                              (True, torch.float64, False),
                                              (False, torch.float32, True),
                                              (False, torch.bfloat16, True)])
def test_bf16_sites_route_by_dtype(cuda, dtype, takes):
    """The GroupNorm fold, the two-source conv3x3 and the upsample send a
    bf16 tensor on the card (and any CPU tensor) to their wrappers, and
    another dtype on the card to their plain versions; inside
    ``plain_versions()`` none goes to a wrapper. Before F8 an f32 network on
    the card raised at these sites."""
    x = types.SimpleNamespace(is_cuda=cuda, dtype=dtype)
    assert bf16_site(x) is takes
    with plain_versions():
        assert bf16_site(x) is False
