"""The port's checkpoint files on the CPU: its safetensors reader and writer
against the safetensors package (both ways), diffusers pipeline
directories written by the JAX package's own exporters (plain and sharded)
loaded with ``load_diffusers_checkpoint``, the peft-format LoRA keys
against the JAX package's, and the port's exports read back by the JAX
package's importers. TINY configs, float32 unless a test says otherwise."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svd_xtend_tpu.core import config as jcfg
from svd_xtend_tpu.diffusion import pipeline as jpipe
from svd_xtend_tpu.io import convert as jconv
from svd_xtend_tpu.models import lora as jlora
from svd_xtend_tpu_torch.core import config as tcfg
from svd_xtend_tpu_torch.diffusion import pipeline as tpipe
from svd_xtend_tpu_torch.io import convert as tconv
from svd_xtend_tpu_torch.io import safetensors_io as st
from svd_xtend_tpu_torch.train.checkpoint import export_lora_diffusers, export_unet_diffusers

torch.set_num_threads(1)

UNET_FILE = "diffusion_pytorch_model.safetensors"


# ----------------------------------------------------------- safetensors --

def _tensors():
    """Every dtype the port reads, odd sizes (so the layout needs its
    ordering), a 0-d and an empty tensor; values seeded through numpy."""
    rs = np.random.RandomState(0)
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    return {"w.f32": f(3, 5), "w.bf16": f(7).bfloat16(), "w.f16": f(2, 3).half(),
            "ids": torch.from_numpy(rs.randint(-9, 9, 5).astype(np.int64)),
            "f64": f(3).double(), "i32": torch.tensor([1, -2, 3], dtype=torch.int32),
            "i16": torch.tensor([5], dtype=torch.int16),
            "u8": torch.tensor([1, 2, 3], dtype=torch.uint8),
            "i8": torch.tensor([-1], dtype=torch.int8), "mask": torch.tensor([True, False]),
            "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4)}


def _equal(got, want):
    assert list(sorted(got)) == list(sorted(want))
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_safetensors_writer_matches_the_package(tmp_path):
    """The same bytes as the package's save_file (tensor order, header
    padding to 8 bytes, a one-key metadata: the package orders several
    keys as a hash map does); the package reads them back, metadata too."""
    pkg = pytest.importorskip("safetensors.torch")
    safetensors = pytest.importorskip("safetensors")
    ts = _tensors()
    mine = st.save_file(ts, str(tmp_path / "mine.safetensors"), metadata={"format": "pt"})
    theirs = str(tmp_path / "theirs.safetensors")
    pkg.save_file(ts, theirs, metadata={"format": "pt"})
    raw = open(mine, "rb").read()
    assert raw == open(theirs, "rb").read()
    assert int.from_bytes(raw[:8], "little") % 8 == 0
    meta = {"format": "pt", "note": "seed 0"}
    mine = st.save_file(ts, str(tmp_path / "meta.safetensors"), metadata=meta)
    _equal(pkg.load_file(mine), ts)
    with safetensors.safe_open(mine, "pt") as f:
        assert f.metadata() == meta


@pytest.mark.parametrize("meta", [None, {"format": "pt"}])
def test_safetensors_reader_reads_package_files(tmp_path, meta):
    pkg = pytest.importorskip("safetensors.torch")
    ts, path = _tensors(), str(tmp_path / "theirs.safetensors")
    pkg.save_file(ts, path, metadata=meta)
    _equal(st.load_file(path), ts)
    assert st.load_metadata(path) == (meta or {})


def test_safetensors_reader_rejects_malformed_files(tmp_path):
    path = st.save_file(_tensors(), str(tmp_path / "x.safetensors"))
    raw = open(path, "rb").read()
    cases = {"truncated": raw[:-3], "short": raw[:5],
             "header past the end": (10**6).to_bytes(8, "little") + raw[8:],
             "unknown dtype": raw.replace(b'"I8"', b'"Q8"')}
    for name, data in cases.items():
        bad = tmp_path / f"{name}.safetensors"
        bad.write_bytes(data)
        with pytest.raises(ValueError):
            st.load_file(str(bad))


# ------------------------------------------------- pipeline directories --

@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """A TINY pipeline directory written by the JAX package's exporters, a
    copy whose UNet is split in two shards with an index, and the port's
    state dicts of the same params (state_dict_from_jax)."""
    jm = jpipe.SVDModels(unet_config=jcfg.TINY_UNET, vae_config=jcfg.TINY_VAE,
                         clip_config=jcfg.TINY_CLIP, dtype=jnp.float32)
    params = jpipe.init_pipeline_params(jm, jax.random.PRNGKey(0))
    plain = tmp_path_factory.mktemp("plain")
    files = {"unet": jconv.flax_to_diffusers(params["unet"]),
             "vae": jconv.flax_to_diffusers(params["vae"]),
             "image_encoder": jconv.clip_flax_to_transformers(
                 params["clip"], patch_size=jcfg.TINY_CLIP.patch_size)}
    for sub, sd in files.items():
        os.makedirs(plain / sub)
        name = "model.safetensors" if sub == "image_encoder" else UNET_FILE
        jconv.save_safetensors(str(plain / sub / name), sd, metadata={"format": "pt"})
    sharded = tmp_path_factory.mktemp("sharded")
    for sub in ("vae", "image_encoder"):
        shutil.copytree(plain / sub, sharded / sub)
    os.makedirs(sharded / "unet")
    keys = sorted(files["unet"])
    weight_map = {}
    for i, part in enumerate((keys[::2], keys[1::2])):
        shard = f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"
        jconv.save_safetensors(str(sharded / "unet" / shard),
                               {k: files["unet"][k] for k in part})
        weight_map.update({k: shard for k in part})
    total = sum(np.asarray(v).nbytes for v in files["unet"].values())
    with open(sharded / "unet" / (UNET_FILE + ".index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    want = tconv.state_dict_from_jax(jconv.flatten(params), jcfg.TINY_CLIP.patch_size)
    return {"plain": plain, "sharded": sharded, "want": want, "params": params}


def _port_models(dtype=torch.float32):
    return tpipe.SVDModels.create(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_CLIP,
                                  device="cpu", dtype=dtype)


@pytest.mark.parametrize("layout,dtype", [("plain", "float32"), ("sharded", "float32"),
                                          ("plain", "bfloat16")])
def test_load_diffusers_checkpoint_matches_state_dict_from_jax(pipeline, layout, dtype):
    """Every tensor of every component bit for bit (cast to the networks'
    dtype, as load_state_dict does)."""
    dt = getattr(torch, dtype)
    models = tconv.load_diffusers_checkpoint(str(pipeline[layout]), _port_models(dt))
    for name in ("unet", "vae", "clip"):
        sd = getattr(models, name).state_dict()
        want = pipeline["want"][name]
        assert set(sd) == set(want)
        for k, v in want.items():
            assert torch.equal(sd[k], v.to(dt)), (name, k)


def test_load_component_state_follows_the_shard_index(pipeline):
    sd = tconv.load_component_state(str(pipeline["sharded"] / "unet"), UNET_FILE)
    plain = tconv.load_component_state(str(pipeline["plain"] / "unet"), UNET_FILE)
    _equal(sd, plain)


def test_load_diffusers_checkpoint_loads_only_the_components_asked(pipeline):
    models = _port_models()
    before = {k: v.clone() for k, v in models.unet.state_dict().items()}
    tconv.load_diffusers_checkpoint(str(pipeline["plain"]), models, components=("vae",))
    _equal(models.unet.state_dict(), before)
    _equal(models.vae.state_dict(), pipeline["want"]["vae"])
    with pytest.raises(ValueError):
        tconv.load_diffusers_checkpoint(str(pipeline["plain"]), models, components=("text",))


def test_load_diffusers_checkpoint_raises_on_a_missing_tensor(pipeline, tmp_path):
    root = tmp_path / "pipe"
    shutil.copytree(pipeline["plain"], root)
    path = str(root / "vae" / UNET_FILE)
    sd = st.load_file(path)
    sd.pop(sorted(sd)[0])
    st.save_file(sd, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        tconv.load_diffusers_checkpoint(str(root), _port_models(), components=("vae",))
    index = {"weight_map": {k: UNET_FILE for k in pipeline["want"]["vae"]}}
    (root / "vae" / (UNET_FILE + ".index.json")).write_text(json.dumps(index))
    with pytest.raises(ValueError):
        tconv.load_component_state(str(root / "vae"), UNET_FILE)


def _clip_file_edited(pipeline, root, edit):
    """A copy of the plain pipeline directory whose CLIP file `edit` changed."""
    shutil.copytree(pipeline["plain"], root)
    path = str(root / "image_encoder" / "model.safetensors")
    sd = st.load_file(path)
    edit(sd)
    st.save_file(sd, path)
    return str(root)


def test_clip_file_with_a_key_the_tower_lacks_loads_in_both(pipeline, tmp_path):
    """A CLIP file that also holds ``vision_model.embeddings.position_ids``
    (transformers before 4.31 saved the buffer): the JAX loader reads only
    its template's keys and the port drops the extra one; both load the
    tower's weights, equal to each other."""
    extra = lambda sd: sd.update({"vision_model.embeddings.position_ids":
                                  torch.arange(5, dtype=torch.int64)[None]})
    root = _clip_file_edited(pipeline, tmp_path / "pipe", extra)
    models = tconv.load_diffusers_checkpoint(root, _port_models(), components=("clip",))
    jparams = jconv.load_diffusers_checkpoint(root, pipeline["params"], components=("clip",),
                                              clip_patch_size=jcfg.TINY_CLIP.patch_size)
    want = tconv.clip_state_dict(jconv.flatten(jax.device_get(jparams["clip"])),
                                 jcfg.TINY_CLIP.patch_size)
    _equal(models.clip.state_dict(), want)
    _equal(models.clip.state_dict(), pipeline["want"]["clip"])


def test_clip_file_missing_a_tower_key_raises_in_both(pipeline, tmp_path):
    drop = lambda sd: sd.pop("vision_model.post_layernorm.weight")
    root = _clip_file_edited(pipeline, tmp_path / "pipe", drop)
    with pytest.raises(RuntimeError, match="Missing key"):
        tconv.load_diffusers_checkpoint(root, _port_models(), components=("clip",))
    with pytest.raises(ValueError, match="missing CLIP key"):
        jconv.load_diffusers_checkpoint(root, pipeline["params"], components=("clip",),
                                        clip_patch_size=jcfg.TINY_CLIP.patch_size)


# ------------------------------------------------------------------ LoRA --

def _jax_lora(params, seed=5):
    rs = np.random.RandomState(seed)
    return {path: {"a": np.asarray(ab["a"]),
                   "b": (rs.randn(*ab["b"].shape) * 0.1).astype(np.float32)}
            for path, ab in jlora.init(jax.random.PRNGKey(seed), params).items()}


def test_lora_state_dict_matches_jax_lora_flax_to_diffusers(pipeline):
    jtree = _jax_lora(pipeline["params"]["unet"])
    want = jconv.lora_flax_to_diffusers(jtree)
    got = tconv.lora_state_dict(tconv.lora_from_jax(jtree))
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_lora_from_state_dict_round_trips_and_checks_shapes(pipeline):
    ad = tconv.lora_from_jax(_jax_lora(pipeline["params"]["unet"]))
    sd = tconv.lora_state_dict(ad)
    back = tconv.lora_from_state_dict(sd, ad)
    assert list(back) == list(ad)
    for name, ab in ad.items():
        assert torch.equal(back[name]["a"], ab["a"]) and torch.equal(back[name]["b"], ab["b"])
    key = next(iter(sd))
    with pytest.raises(ValueError):
        tconv.lora_from_state_dict({**sd, key: sd[key][:, :-1]}, ad)


def test_exported_lora_file_reads_back_in_jax(pipeline, tmp_path):
    """pytorch_lora_weights.safetensors from export_lora_diffusers, through
    the JAX package's reader and lora_diffusers_to_flax: JAX's tree, bit
    for bit; metadata {"format": "pt"}."""
    jtree = _jax_lora(pipeline["params"]["unet"])
    path = export_lora_diffusers(tconv.lora_from_jax(jtree), str(tmp_path / "lora"))
    assert os.path.basename(path) == "pytorch_lora_weights.safetensors"
    assert st.load_metadata(path) == {"format": "pt"}
    back = jconv.lora_diffusers_to_flax(jconv.load_safetensors(path), jtree)
    assert list(back) == list(jtree)
    for p, ab in jtree.items():
        np.testing.assert_array_equal(back[p]["a"], ab["a"])
        np.testing.assert_array_equal(back[p]["b"], ab["b"])


def test_exported_unet_reads_back_in_jax(pipeline, tmp_path):
    """export_unet_diffusers' file through the JAX package's
    diffusers_to_flax: the JAX params, bit for bit."""
    models = tconv.load_diffusers_checkpoint(str(pipeline["plain"]), _port_models(),
                                             components=("unet",))
    path = export_unet_diffusers(models.unet, str(tmp_path / "unet"), config_json='{"a": 1}')
    assert st.load_metadata(path) == {"format": "pt"}
    assert json.loads((tmp_path / "unet" / "config.json").read_text()) == {"a": 1}
    template = pipeline["params"]["unet"]
    back = jconv.flatten(jconv.diffusers_to_flax(jconv.load_safetensors(path), template))
    for k, v in jconv.flatten(template).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
