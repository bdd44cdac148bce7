"""The port's training harness against the JAX package on the CPU: the
frame-folder dataset (its sampling, both decode paths, the loader and its
resume), the native loader's build and the committed frame fixture, resume
checkpoints, per-step generators, the configs' JSON, the optimizer's and the
train state's state dicts, the video metrics and the media writers. Inputs
are made from seeds with numpy; JPEG folders are written with PIL.

Run as a script, this file (re)writes the fixture's reference window, the
JAX package's native loader output for one window of the committed frames:

    python tests/test_torch_port_harness.py
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from svd_xtend_tpu import native as jnative
from svd_xtend_tpu.core import config as jcfg
from svd_xtend_tpu.data import dataset as jdata
from svd_xtend_tpu.diffusion import pipeline as jpipe
from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu.io import media as jmedia
from svd_xtend_tpu.utils import eval as jeval
from svd_xtend_tpu_torch import native as tnative
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.data import dataset as tdata
from svd_xtend_tpu_torch.data import make_fixtures
from svd_xtend_tpu_torch.diffusion import pipeline as tpipe
from svd_xtend_tpu_torch.io import media as tmedia
from svd_xtend_tpu_torch.io.convert import state_dict_from_jax
from svd_xtend_tpu_torch.train import checkpoint as tckpt
from svd_xtend_tpu_torch.train import cli as tcli
from svd_xtend_tpu_torch.train import state as tstate
from svd_xtend_tpu_torch.utils import eval as teval

torch.set_num_threads(1)

REF_WINDOW = make_fixtures.REFERENCE
REF_FRAMES, REF_W, REF_H = (make_fixtures.REF_FRAMES, make_fixtures.REF_WIDTH,
                            make_fixtures.REF_HEIGHT)
reference_paths = make_fixtures.reference_paths


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """3 videos of 7, 9 and 8 seeded 48x64 JPEG frames, and a fourth video
    whose frames are PNGs (the PIL path under use_native)."""
    root = tmp_path_factory.mktemp("videos")
    rs = np.random.RandomState(0)
    for v, n in enumerate((7, 9, 8)):
        d = root / f"video{v}"
        d.mkdir()
        base = rs.randint(0, 255, (48, 64, 3))
        for f in range(n):
            arr = np.clip(base + 9 * f + rs.randint(-20, 20, base.shape), 0, 255)
            Image.fromarray(arr.astype(np.uint8)).save(d / f"{f:04d}.jpg", quality=92)
    d = root / "video3"
    d.mkdir()
    for f in range(6):
        Image.fromarray(rs.randint(0, 255, (40, 56, 3)).astype(np.uint8)).save(d / f"{f:03d}.png")
    return str(root)


# ---------------------------------------------------------------- dataset --

def test_sample_spec_matches_jax(folder):
    rs = np.random.RandomState(1)
    jds = jdata.FrameFolderDataset(folder, 32, 24, sample_frames=5)
    tds = tdata.FrameFolderDataset(folder, 32, 24, sample_frames=5)
    triples = zip(rs.randint(0, 2**31, 200), rs.randint(0, 10**6, 200), rs.randint(0, 64, 200))
    for seed, step, pos in triples:
        seed, step, pos = int(seed), int(step), int(pos)
        assert tds.sample_spec(seed, step, pos) == jds.sample_spec(seed, step, pos)


@pytest.mark.parametrize("use_native", [False, True])
def test_load_window_matches_jax_bit_for_bit(folder, use_native):
    """Every window of every video (JPEG and PNG), through the PIL path or
    the native one, equal to the JAX package's same path."""
    jds = jdata.FrameFolderDataset(folder, 40, 24, sample_frames=5, use_native=use_native)
    tds = tdata.FrameFolderDataset(folder, 40, 24, sample_frames=5, use_native=use_native)
    for vid, (_, frames) in enumerate(tds.videos):
        for start in range(len(frames) - 5 + 1):
            got, want = tds.load_window(vid, start), jds.load_window(vid, start)
            assert got.dtype == np.float32 and got.shape == (5, 24, 40, 3)
            np.testing.assert_array_equal(got, want)


def test_load_window_on_the_fixture_matches_jax(folder):
    """The committed 1280x720 frames, native and PIL paths, at the training
    size against the JAX package's."""
    for use_native in (True, False):
        jds = jdata.FrameFolderDataset(make_fixtures.FRAMES, 512, 320, 14, use_native=use_native)
        tds = tdata.FrameFolderDataset(make_fixtures.FRAMES, 512, 320, 14, use_native=use_native)
        np.testing.assert_array_equal(tds.load_window(1, 2), jds.load_window(1, 2))


def test_fixture_reference_window_is_the_jax_native_output():
    """The committed .npy is the JAX package's native loader output for its
    window, bit for bit, and the port's native loader gives the same; the
    frame folder is 2 videos x 16 frames of 1280x720 JPEG under 2 MB."""
    ref = np.load(REF_WINDOW)
    assert ref.shape == (REF_FRAMES, REF_H, REF_W, 3) and ref.dtype == np.float32
    np.testing.assert_array_equal(jnative.load_clip(reference_paths(), REF_W, REF_H), ref)
    np.testing.assert_array_equal(tnative.load_clip(reference_paths(), REF_W, REF_H), ref)
    videos = sorted(os.listdir(make_fixtures.FRAMES))
    assert len(videos) == 2
    total = 0
    for v in videos:
        frames = sorted(os.listdir(os.path.join(make_fixtures.FRAMES, v)))
        assert len(frames) == 16 and all(f.endswith(".jpg") for f in frames)
        total += sum(os.path.getsize(os.path.join(make_fixtures.FRAMES, v, f)) for f in frames)
        with Image.open(os.path.join(make_fixtures.FRAMES, v, frames[0])) as img:
            assert img.size == (1280, 720)
    assert total <= 2 * 2**20


def test_fixture_frames_are_the_makers(tmp_path):
    """make_fixtures writes the committed frames' pixels (decoded)."""
    for v in (0, 1):
        for t in (0, 15):
            name = f"video_{v}/{t:05d}.jpg"
            make_fixtures.write_frame(v, t, str(tmp_path / "f.jpg"))
            a = np.asarray(Image.open(tmp_path / "f.jpg"))
            b = np.asarray(Image.open(os.path.join(make_fixtures.FRAMES, name)))
            np.testing.assert_array_equal(a, b)


def test_native_library_builds_into_the_build_directory():
    lib = tnative.library()
    assert os.path.dirname(lib._name) == str(tnative.BUILD_DIR)
    assert tnative.BUILD_DIR.parts[-2:] == ("_build", "native")
    assert tnative.decoder() in tnative.DECODERS
    src_dir = os.path.dirname(tnative.__file__)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


@pytest.fixture(scope="module")
def jpeg_variety(tmp_path_factory):
    """Seeded JPEGs of the kinds a frame folder holds: 4:4:4, 4:2:2 and
    4:2:0 chroma, qualities 30-100, standard and optimised Huffman tables,
    sizes that are not multiples of the MCU, grayscale, restart intervals;
    and one progressive file."""
    root = tmp_path_factory.mktemp("jpegs")
    rs = np.random.RandomState(1)
    paths = []

    def save(arr, name, **kw):
        paths.append(str(root / name))
        Image.fromarray(arr).save(paths[-1], **kw)

    for sub in (0, 1, 2):
        for q in (30, 75, 95, 100):
            for hh, ww in ((77, 101), (17, 9), (64, 64)):
                y, x = np.mgrid[0:hh, 0:ww]
                arr = np.clip(np.stack([x * 3.1, y * 2.3, (x * y) % 256], -1)
                              + rs.randint(-40, 40, (hh, ww, 3)), 0, 255).astype(np.uint8)
                save(arr, f"s{sub}_q{q}_{hh}x{ww}.jpg", quality=q, subsampling=sub)
                save(arr, f"s{sub}_q{q}_{hh}x{ww}_opt.jpg", quality=q, subsampling=sub,
                     optimize=True)
    noise = rs.randint(0, 256, (90, 130, 3)).astype(np.uint8)
    save(noise[..., 0], "gray.jpg", quality=80)
    save(noise, "restart_blocks.jpg", quality=80, restart_marker_blocks=3)
    save(noise, "restart_rows_420.jpg", quality=80, subsampling=2, restart_marker_rows=1)
    Image.fromarray(noise).save(root / "progressive.jpg", quality=80, progressive=True)
    return paths, str(root / "progressive.jpg")


def test_builtin_decoder_is_libjpegs_bit_for_bit(jpeg_variety):
    """The built-in decoder (the build for machines without libjpeg) gives
    the JAX package's loader's floats bit for bit, at the file's own size
    and resized, on every kind of baseline file and on the committed frames;
    a progressive file is None (its window then takes PIL)."""
    paths, progressive = jpeg_variety
    for p in paths:
        with Image.open(p) as img:
            w, h = img.size
        for size in ((w, h), (max(1, w // 2 + 3), max(1, h // 3 + 1))):
            got = tnative.load_clip([p], *size, decoder="builtin")
            assert got is not None, p
            np.testing.assert_array_equal(got, jnative.load_clip([p], *size), err_msg=p)
    frames = sorted(os.path.join(make_fixtures.FRAMES, v, f)
                    for v in os.listdir(make_fixtures.FRAMES)
                    for f in os.listdir(os.path.join(make_fixtures.FRAMES, v)))
    np.testing.assert_array_equal(tnative.load_clip(frames, 512, 320, decoder="builtin"),
                                  jnative.load_clip(frames, 512, 320))
    np.testing.assert_array_equal(
        tnative.load_clip(reference_paths(), REF_W, REF_H, decoder="builtin"),
        np.load(REF_WINDOW))
    assert tnative.load_clip([progressive], 16, 16, decoder="builtin") is None
    assert "builtin" in tnative.library("builtin").fl_version().decode()


def test_native_decode_failure_is_none_and_the_window_takes_pil(folder, tmp_path):
    """A file the native loader cannot decode: load_clip gives None (as the
    JAX package's), and load_window decodes the window with PIL instead."""
    assert tnative.load_clip([str(tmp_path / "missing.jpg")], 8, 8) is None
    root = tmp_path / "v"
    shutil.copytree(os.path.join(folder, "video0"), root / "video0")
    with Image.open(root / "video0" / "0002.jpg") as img:      # CMYK: libjpeg refuses RGB out
        img.convert("CMYK").save(root / "video0" / "0002.jpg")
    tds = tdata.FrameFolderDataset(str(root), 40, 24, sample_frames=5)
    jds = jdata.FrameFolderDataset(str(root), 40, 24, sample_frames=5)
    np.testing.assert_array_equal(tds.load_window(0, 0), jds.load_window(0, 0))


def test_dataset_errors_match_jax(folder, tmp_path):
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match=r"'video0' has 7 < 8 frames"):
            mod.FrameFolderDataset(folder, sample_frames=8)
        with pytest.raises(ValueError, match="no video folders under"):
            mod.FrameFolderDataset(str(tmp_path))
    with pytest.raises(ValueError, match="A9"):
        tdata.FrameFolderDataset(folder, sample_frames=5, max_boxes=4)


def test_sharded_loader_matches_jax_and_resumes(folder):
    """Batches of steps 0-4 equal the JAX loader's (batch 3, process 1 of 2);
    a loader restarted from state() continues identically."""
    kw = dict(local_batch_size=3, seed=11, num_workers=2, process_index=1, process_count=2)
    jds = jdata.FrameFolderDataset(folder, 32, 24, sample_frames=4)
    tds = tdata.FrameFolderDataset(folder, 32, 24, sample_frames=4)
    jl, tl = jdata.ShardedLoader(jds, **kw), tdata.ShardedLoader(tds, **kw)
    try:
        batches = []
        for _ in range(5):
            got = next(tl)
            np.testing.assert_array_equal(got, next(jl))
            batches.append(got)
        assert tl.state() == jl.state() == {"step": 5, "seed": 11}
        assert len(tl.wait_seconds) == 5 and len(tl.batch_seconds) >= 5
    finally:
        jl.close()
        tl.close()
    state = {"step": 3, "seed": 11}
    again = tdata.ShardedLoader(tds, **{**kw, "seed": state["seed"]}, start_step=state["step"])
    try:
        np.testing.assert_array_equal(next(again), batches[3])
        np.testing.assert_array_equal(next(again), batches[4])
    finally:
        again.close()
    assert not again._thread.is_alive()


def test_sharded_loader_hands_a_producer_error_to_next(folder, tmp_path):
    """A frame that no longer decodes raises in next(), not in a thread
    that dies while next() waits."""
    shutil.copytree(os.path.join(folder, "video3"), tmp_path / "video3")
    ds = tdata.FrameFolderDataset(str(tmp_path), 16, 16, sample_frames=2)
    for f in os.listdir(tmp_path / "video3"):
        (tmp_path / "video3" / f).write_bytes(b"not an image")
    loader = tdata.ShardedLoader(ds, 1, num_workers=1)
    try:
        with pytest.raises(Exception, match="cannot identify image"):
            next(loader)
    finally:
        loader.close()


# ------------------------------------------------------------ checkpoints --

class _State:
    """Stands in for a TrainState in the manager's bookkeeping tests."""

    def __init__(self, step):
        self.step = step

    def state_dict(self):
        return {"step": self.step, "w": torch.full((3,), float(self.step))}

    def load_state_dict(self, sd):
        self.step = sd["step"]


def test_checkpoint_rotation_latest_and_same_step_skip(tmp_path):
    out = str(tmp_path / "out")
    cfg = tcfg.TrainConfig(output_dir=out)
    m = tckpt.CheckpointManager(out, total_limit=2)
    for s in (2, 4):
        m.save(s, _State(s), cfg, {"step": s, "seed": 1})
    # an incomplete directory (a save cut before the rename): never latest,
    # never counted by the rotation
    os.makedirs(os.path.join(out, "checkpoint-9", "state.tmp"))
    assert tckpt.latest_checkpoint(out) == os.path.join(out, "checkpoint-4")
    assert tckpt._ckpt_steps(out) == [2, 4, 9]
    m.save(6, _State(6), cfg, {"step": 6, "seed": 1})
    assert tckpt._ckpt_steps(out) == [4, 6, 9]
    assert tckpt._ckpt_steps(out, complete_only=True) == [4, 6]
    # same step again: skipped, the file untouched
    path = os.path.join(out, "checkpoint-6", "state", tckpt.STATE_FILE)
    before = os.stat(path).st_mtime_ns
    m.save(6, _State(99), cfg, {"step": 99})
    assert os.stat(path).st_mtime_ns == before
    st, got_cfg, data = m.restore("latest", _State(0))
    assert st.step == 6 and data == {"step": 6, "seed": 1} and got_cfg == cfg
    assert sorted(os.listdir(os.path.join(out, "checkpoint-6"))) == [
        "config.json", "data_state.json", "state"]
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(str(tmp_path / "empty")).restore("latest", _State(0))


def test_train_state_state_dict_round_trip():
    """Two steps of the TINY 'full' scope with EMA, saved, loaded into a
    fresh state and stepped on: equal bit for bit to stepping on."""
    cfg = tcfg.TrainConfig(train_mode="full", use_ema=True, learning_rate=1e-3,
                           lr_warmup_steps=0, height=32, width=32, num_frames=2,
                           mixed_precision="no", remat_policy="none")
    batch = torch.from_numpy(np.random.RandomState(3).uniform(-1, 1, (1, 2, 32, 32, 3))
                             .astype(np.float32))

    def build():
        g = torch.Generator().manual_seed(0)
        models = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP,
                                        device="cpu", generator=g)
        state = tstate.create_train_state(cfg, models)
        return models, state, tstate.make_train_step(models, cfg)

    models, state, step = build()
    for s in range(2):
        state, _ = step(state, batch, generator=tcli.step_generator(5, s, "cpu"))
    sd = state.state_dict()
    assert all(t.device.type == "cpu" for t in sd["params"].values())
    models2, state2, step2 = build()
    state2.load_state_dict(sd)
    tcli._write_back(models2, state2)
    for s in range(2, 4):
        state, _ = step(state, batch, generator=tcli.step_generator(5, s, "cpu"))
        state2, _ = step2(state2, batch, generator=tcli.step_generator(5, s, "cpu"))
    a, b = state.state_dict(), state2.state_dict()
    assert a["step"] == b["step"] == 4 and a["optimizer"]["count"] == 4
    for key in ("params", "ema_params"):
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), (key, n)
    for i, s in a["optimizer"]["adamw"]["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[k], b["optimizer"]["adamw"]["state"][i][k])
    bad = dict(sd, params=dict(list(sd["params"].items())[1:]))
    with pytest.raises(ValueError):
        state2.load_state_dict(bad)


def test_step_generators_are_a_function_of_seed_and_step():
    draw = lambda seed, step: torch.randn(4, generator=tcli.step_generator(seed, step, "cpu"))
    assert torch.equal(draw(7, 3), draw(7, 3))
    assert not torch.equal(draw(7, 3), draw(7, 4))
    assert not torch.equal(draw(7, 3), draw(8, 3))
    assert tcli.derived_seed(7, spawn_key=(1,)) != tcli.derived_seed(7, 1)


# ---------------------------------------------------------------- configs --

@pytest.mark.parametrize("name,kw", [
    ("TrainConfig", {}),
    ("TrainConfig", dict(train_mode="lora", learning_rate=3e-5, use_ema=True, mesh=1)),
    ("UNetConfig", {}), ("VAEConfig", {}), ("CLIPVisionConfig", {}), ("PipelineConfig", {})])
def test_config_json_matches_jax(name, kw):
    """to_json of the port's config equals the JAX package's on every field
    both have (the port's are all shared), and from_json of either gives
    the port's config back."""
    tkw, jkw = dict(kw), dict(kw)
    if "mesh" in kw:
        tkw["mesh"], jkw["mesh"] = tcfg.MeshConfig(data=1), jcfg.MeshConfig(data=1)
    t, j = getattr(tcfg, name)(**tkw), getattr(jcfg, name)(**jkw)
    td, jd = json.loads(t.to_json()), json.loads(j.to_json())
    assert set(td) <= set(jd)
    assert td == {k: jd[k] for k in td}
    assert getattr(tcfg, name).from_json(t.to_json()) == t
    assert getattr(tcfg, name).from_json(j.to_json()) == t


# ---------------------------------------------------------------- metrics --

def test_video_metrics_match_jax():
    jm = jpipe.SVDModels(unet_config=jcfg.TINY_UNET, vae_config=jcfg.TINY_VAE,
                         clip_config=jcfg.TINY_CLIP, dtype=jnp.float32)
    size = jcfg.TINY_CLIP.image_size
    params = {"clip": jm.clip().init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, size, size, 3)))["params"]}
    models = tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP,
                                    device="cpu")
    models.clip.load_state_dict(state_dict_from_jax(
        {f"clip/{k}": v for k, v in jconv.flatten(params["clip"]).items()},
        tcfg.TINY_CLIP.patch_size)["clip"], strict=True)
    rs = np.random.RandomState(4)
    video = rs.uniform(-1, 1, (2, 3, 32, 40, 3)).astype(np.float32)
    image = rs.uniform(-1, 1, (2, 32, 40, 3)).astype(np.float32)
    want = jeval.video_metrics(jm, params, jnp.asarray(video), jnp.asarray(image))
    got = teval.video_metrics(models, torch.from_numpy(video), torch.from_numpy(image))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=0, atol=1e-5, err_msg=k)
    one = teval.video_metrics(models, torch.from_numpy(video[:, :1]), torch.from_numpy(image))
    assert one["clip_temporal_consistency"].item() == 1.0 and one["pixel_dynamics"].item() == 0


# ------------------------------------------------------------------ media --

def _frames(n=4, h=36, w=52):
    rs = np.random.RandomState(6)
    y, x = np.mgrid[0:h, 0:w]
    return [np.clip(np.stack([x * 4 + 9 * t, y * 6 + 5 * t, (x + y) * 2], -1)
                    + rs.randint(-30, 30, (h, w, 3)), 0, 255).astype(np.uint8)
            for t in range(n)]


@pytest.mark.parametrize("duration_ms", [500, 120])
def test_export_to_gif_reads_back_as_jax_gif(tmp_path, duration_ms):
    """PIL reads the port's GIF with the frame count, size, per-frame
    duration and loop of the JAX package's (PIL-written) GIF; each decoded
    frame is within the palette's stated error of its source, per channel;
    float frames in [0, 1] and the .mp4 -> .gif renaming as in JAX."""
    frames = _frames()
    mine = tmedia.export_to_gif(frames, str(tmp_path / "mine.mp4"), duration_ms=duration_ms)
    theirs = jmedia.export_to_gif(frames, str(tmp_path / "theirs.mp4"), duration_ms=duration_ms)
    assert mine.endswith("mine.gif") and theirs.endswith("theirs.gif")
    with Image.open(mine) as a, Image.open(theirs) as b:
        assert a.format == "GIF" and a.n_frames == b.n_frames == len(frames)
        assert a.size == b.size == (52, 36)
        assert a.info["loop"] == b.info["loop"] == 0
        for i, src in enumerate(frames):
            a.seek(i)
            b.seek(i)
            assert a.info["duration"] == b.info["duration"] == duration_ms
            err = np.abs(np.asarray(a.convert("RGB"), np.float32) - src).max(axis=(0, 1))
            assert np.all(err <= np.array(tmedia.PALETTE_ERROR)), err
    floats = [f.astype(np.float32) / 255.0 for f in frames]
    path = tmedia.export_to_gif(floats, str(tmp_path / "floats.gif"))
    ref = tmedia._to_uint8(floats)
    assert all(np.array_equal(x, y) for x, y in zip(ref, jmedia._to_uint8(floats)))
    with Image.open(path) as a:
        a.seek(3)
        err = np.abs(np.asarray(a.convert("RGB"), np.float32) - ref[3]).max(axis=(0, 1))
        assert np.all(err <= np.array(tmedia.PALETTE_ERROR))


def test_gif_lzw_survives_table_resets(tmp_path):
    """Noise at 256 levels fills the LZW table many times over: the codes
    still decode (PIL) to the palette's quantisation of the source."""
    rs = np.random.RandomState(8)
    frames = [rs.randint(0, 256, (90, 130, 3)).astype(np.uint8) for _ in range(2)]
    path = tmedia.export_to_gif(frames, str(tmp_path / "noise.gif"))
    pal = tmedia._palette()
    with Image.open(path) as a:
        for i, src in enumerate(frames):
            a.seek(i)
            idx = np.frombuffer(tmedia._indices(src), np.uint8).reshape(90, 130)
            np.testing.assert_array_equal(np.asarray(a.convert("RGB")), pal[idx])


def test_export_to_video_without_cv2_or_imageio_raises_naming_both(tmp_path, monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    with pytest.raises(ImportError, match="cv2 or imageio"):
        tmedia.export_to_video(_frames(n=2), str(tmp_path / "v.mp4"))


def test_export_to_video_round_trips_through_cv2(tmp_path):
    cv2 = pytest.importorskip("cv2")
    frames = _frames(n=6, h=64, w=96)
    path = tmedia.export_to_video(frames, str(tmp_path / "v.mp4"), fps=7)
    cap = cv2.VideoCapture(path)
    try:
        assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(7)
        got = []
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            got.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    assert len(got) == len(frames) and got[0].shape == (64, 96, 3)
    for g, f in zip(got, frames):       # mp4v is lossy: the mean, not the bits
        assert np.abs(g.astype(np.float32) - f).mean() < 12


if __name__ == "__main__":
    np.save(REF_WINDOW, jnative.load_clip(reference_paths(), REF_W, REF_H))
    print("wrote", REF_WINDOW)
