"""JAX-package parameters -> the port's state dicts; the reference's
checkpoint files (diffusers pipeline directories, peft LoRA files).

The port's modules carry the diffusers (UNet, VAE) and transformers (CLIP)
state-dict names and layouts, so this applies the same name and layout rules
as ``svd_xtend_tpu/io/convert.py::flax_to_diffusers`` and
``clip_flax_to_transformers`` (without importing jax):

  - Dense:          flax (in, out)     -> torch (out, in)
  - Conv2d:         flax HWIO          -> torch OIHW
  - temporal conv:  flax (3, 1, I, O)  -> torch (O, I, 3, 1, 1)
  - CLIP patch-embed: flax (p·p·3, width) matmul -> Conv2d (width, 3, p, p)
  - norms: scale -> weight; ``mix_factor`` keeps its name.

Input is the flat ``{"a/b/kernel": array}`` form of
``svd_xtend_tpu.io.convert.flatten``; load the results with
``load_state_dict(strict=True)``. Since the modules carry the files' names
and layouts, a diffusers pipeline directory loads the same way
(``load_diffusers_checkpoint``, the reference's ``from_pretrained``,
train_svd.py:643-656), and a LoRA adapter maps to peft's keys one to one
(``lora_state_dict``; save_lora_weights, train_svd_lora.py:1070-1074).
Files are read with the port's own safetensors reader (io/safetensors_io.py).

The Tracklet2Video branch (``tracklet_conditioner``, ``gated_attentions``)
has no diffusers counterpart: ``diffusers_state_dict`` skips it, as
``flax_to_diffusers`` does, and its own exchange file (the JAX CLI's
``tracklet_weights.safetensors``) holds the JAX package's flat flax paths
and layouts (Dense kernels (in, out), ``embedding``, ``scale``):
``tracklet_state_dict`` reads such a dict into the port's names,
``tracklet_branch_to_flat`` writes one (convert.py:216-235 in the JAX
package). A stock diffusers UNet loads into a tracklet UNet with the branch
left as it was; every other key stays strict.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.lora import Adapter
from .safetensors_io import load_file

_INDEXED = ("down_blocks|up_blocks|resnets|attentions|transformer_blocks|"
            "temporal_transformer_blocks|downsamplers|upsamplers|layers|gated_attentions")
_SEG_RE = re.compile(rf"^({_INDEXED})_(\d+)$")
_VAE_RE = re.compile(r"^(down_blocks|up_blocks)_(\d+)_(resnets|downsamplers|upsamplers)_(\d+)$")
_MID_RE = re.compile(r"^mid_(resnets|attentions)_(\d+)$")
# subtrees of the JAX package with no diffusers counterpart (Tracklet2Video)
_EXTENSION_PREFIXES = ("tracklet_conditioner",)
_EXTENSION_SEGMENTS = ("gated_attentions_",)


def _module_key(path: str) -> str:
    """flax module path 'a/b_0/c' -> torch module key 'a.b.0.c'."""
    segs = []
    for seg in path.split("/"):
        m = _VAE_RE.match(seg)
        if m:
            segs.append(f"{m.group(1)}.{m.group(2)}.{m.group(3)}.{m.group(4)}")
            continue
        m = _MID_RE.match(seg)
        if m:
            segs.append(f"mid_block.{m.group(1)}.{m.group(2)}")
            continue
        m = _SEG_RE.match(seg)
        segs.append(f"{m.group(1)}.{m.group(2)}" if m else seg)
    key = ".".join(segs)
    for ff in ("ff", "ff_in"):
        key = key.replace(f"{ff}.net_0_proj", f"{ff}.net.0.proj")
        key = key.replace(f"{ff}.net_2", f"{ff}.net.2")
    return re.sub(r"\bto_out\b", "to_out.0", key)


# the flax axis at each torch axis of a kernel: Dense (in, out) -> (out, in);
# Conv HWIO and the temporal conv's (3, 1, I, O) -> (O, I, kh, kw)
_TORCH_AXES = {2: (1, 0), 4: (3, 2, 0, 1)}


def _kernel(path: str, arr: np.ndarray) -> np.ndarray:
    temporal = ("temporal_res_block" in path or "time_conv_out" in path)
    if arr.ndim not in _TORCH_AXES:
        raise ValueError(f"unhandled kernel rank for {path}: {arr.shape}")
    out = arr.transpose(_TORCH_AXES[arr.ndim])
    if arr.ndim == 4 and temporal and arr.shape[:2] == (3, 1):
        return out[..., None]
    return out


def flax_axes(name: str, ndim: int) -> Optional[Tuple[int, ...]]:
    """The permutation of a UNet parameter's (or a LoRA factor's) axes that
    gives its JAX leaf's layout, ``_kernel``'s inverse: ``t.permute(axes)``
    flattens in the JAX package's order (a temporal conv's trailing axis of
    1 last). None where the layouts are the same: 1-D tensors and the
    Tracklet2Video instance embedding."""
    if ndim == 1 or name.endswith("instance_embedding.weight"):
        return None
    if ndim == 5:
        return flax_axes(name, 4) + (4,)
    if ndim not in _TORCH_AXES:
        raise ValueError(f"{name}: no JAX layout for a tensor of {ndim} axes")
    return tuple(int(a) for a in np.argsort(_TORCH_AXES[ndim]))


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, copy=True, order="C"))


def _is_extension_path(path: str) -> bool:
    return path.startswith(_EXTENSION_PREFIXES) or any(s in path for s in _EXTENSION_SEGMENTS)


def is_branch_key(name: str) -> bool:
    """A port parameter name of the Tracklet2Video branch."""
    return name.startswith("tracklet_conditioner.") or ".gated_attentions." in name


def _flat_to_torch(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        base, leaf = path.rsplit("/", 1) if "/" in path else ("", path)
        prefix = _module_key(base) + "." if base else ""
        arr = np.asarray(arr)
        if leaf == "kernel":
            out[f"{prefix}weight"] = _tensor(_kernel(path, arr))
        elif leaf in ("scale", "embedding"):
            out[f"{prefix}weight"] = _tensor(arr)
        elif leaf == "mix_factor":
            out[f"{prefix}mix_factor"] = _tensor(arr.reshape(-1))
        else:
            out[f"{prefix}{leaf}"] = _tensor(arr)
    return out


def diffusers_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """UNet or VAE flat params -> diffusers-named state dict (without the
    Tracklet2Video branch)."""
    return _flat_to_torch({p: a for p, a in flat.items() if not _is_extension_path(p)})


def tracklet_state_dict(flat: Mapping) -> Dict[str, torch.Tensor]:
    """The Tracklet2Video branch of flat UNet params (flax paths and layouts,
    as ``tracklet_branch_to_flat`` and the JAX package write them; numpy
    arrays or tensors) -> the port's state-dict entries; other paths are
    skipped."""
    as_np = lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    return _flat_to_torch({p: as_np(a) for p, a in flat.items() if _is_extension_path(p)})


@torch.no_grad()
def tracklet_branch_into_unet(flat: Mapping, unet: torch.nn.Module) -> torch.nn.Module:
    """Copy a ``tracklet_branch_to_flat`` dict (the JAX package's format)
    into a tracklet UNet's branch, in place, cast to its dtype and device;
    raises where a path has no parameter or another shape (JAX's
    ``tracklet_branch_into_tree``). Returns the UNet."""
    other = sorted(p for p in flat if not _is_extension_path(p))
    if other:
        raise ValueError(f"not Tracklet2Video paths: {other[:5]}... ({len(other)})")
    sd = tracklet_state_dict(flat)
    params = unet.state_dict()
    unknown = sorted(set(sd) - set(params))
    if unknown:
        raise ValueError(f"unknown tracklet params: {unknown[:5]}... ({len(unknown)})")
    for name, t in sd.items():
        if t.shape != params[name].shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(params[name].shape)}")
        params[name].copy_(t)
    return unet


def _flax_path(name: str) -> str:
    """A port branch parameter name -> its flax path (_module_key's inverse
    on the branch: 'a.0.b.weight' -> 'a_0/b/kernel' and so on)."""
    key = name.replace("to_out.0.", "to_out.")
    for ff in ("ff", "ff_in"):
        key = key.replace(f"{ff}.net.0.proj.", f"{ff}.net_0_proj.")
        key = key.replace(f"{ff}.net.2.", f"{ff}.net_2.")
    segs: list = []
    for seg in key.split("."):
        if seg.isdigit() and segs:
            segs[-1] += "_" + seg
        else:
            segs.append(seg)
    return "/".join(segs)


def tracklet_branch_to_flat(unet_or_sd) -> Dict[str, np.ndarray]:
    """The UNet's Tracklet2Video branch (a module or a state dict) as the
    JAX package's flat dict: flax paths, Dense kernels (in, out), the
    instance embedding as ``embedding``, norm weights as ``scale``; f32
    numpy arrays. The exchange file of a box-conditioned finetune."""
    sd = unet_or_sd.state_dict() if isinstance(unet_or_sd, torch.nn.Module) else unet_or_sd
    out: Dict[str, np.ndarray] = {}
    for name, t in sd.items():
        if not is_branch_key(name):
            continue
        path = _flax_path(name)
        arr = t.detach().float().cpu().numpy()
        base, leaf = path.rsplit("/", 1)
        if leaf == "weight" and base.endswith("instance_embedding"):
            leaf = "embedding"
        elif leaf == "weight" and arr.ndim == 2:
            leaf, arr = "kernel", arr.T
        elif leaf == "weight":
            leaf = "scale"
        out[f"{base}/{leaf}"] = np.ascontiguousarray(arr)
    if not out:
        raise ValueError("the UNet has no Tracklet2Video branch")
    return out


def clip_state_dict(flat: Mapping[str, np.ndarray], patch_size: int = 14
                    ) -> Dict[str, torch.Tensor]:
    """CLIP flat params -> transformers-named state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        arr = np.asarray(arr)
        if path == "patch_embedding/kernel":
            width = arr.shape[1]
            key = "vision_model.embeddings.patch_embedding.weight"
            arr = arr.reshape(patch_size, patch_size, 3, width).transpose(3, 2, 0, 1)
        elif path == "class_embedding":
            key = "vision_model.embeddings.class_embedding"
        elif path == "position_embedding":
            key = "vision_model.embeddings.position_embedding.weight"
        elif path.startswith(("pre_layrnorm/", "post_layernorm/")):
            name, leaf = path.split("/")
            key = f"vision_model.{name}.{'weight' if leaf == 'scale' else 'bias'}"
        elif path == "visual_projection/kernel":
            key, arr = "visual_projection.weight", arr.T
        else:
            m = re.match(r"^layers_(\d+)/(.+)/(kernel|scale|bias)$", path)
            if not m:
                raise ValueError(f"unmapped CLIP param {path}")
            i, base, leaf = m.groups()
            if base in ("q_proj", "k_proj", "v_proj", "out_proj"):
                base = f"self_attn.{base}"
            base = base.replace("/", ".")
            key = (f"vision_model.encoder.layers.{i}.{base}."
                   f"{'bias' if leaf == 'bias' else 'weight'}")
            if leaf == "kernel":
                arr = arr.T
        out[key] = _tensor(arr)
    return out


def state_dict_from_jax(flat: Mapping[str, np.ndarray], clip_patch_size: int = 14
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Flat params of the JAX pipeline ({"unet/...", "vae/...", "clip/..."})
    -> {"unet": sd, "vae": sd, "clip": sd} for the port's modules (the
    UNet's with its Tracklet2Video branch where it has one)."""
    parts: Dict[str, Dict[str, np.ndarray]] = {}
    for path, arr in flat.items():
        comp, rest = path.split("/", 1)
        parts.setdefault(comp, {})[rest] = arr
    unknown = set(parts) - {"unet", "vae", "clip"}
    if unknown:
        raise ValueError(f"unknown components {sorted(unknown)}")
    out = {name: diffusers_state_dict(parts[name])
           for name in ("unet", "vae") if name in parts}
    if "unet" in parts:
        out["unet"].update(tracklet_state_dict(parts["unet"]))
    if "clip" in parts:
        out["clip"] = clip_state_dict(parts["clip"], clip_patch_size)
    return out


# ------------------------------------------------------------------ LoRA --

def lora_state_dict(lora: Adapter) -> Dict[str, torch.Tensor]:
    """Adapter -> peft/diffusers keys: unet.<module>.lora_A.weight (r, in)
    and unet.<module>.lora_B.weight (out, r)."""
    out: Dict[str, torch.Tensor] = {}
    for name, ab in lora.items():
        out[f"unet.{name}.lora_A.weight"] = ab["a"]
        out[f"unet.{name}.lora_B.weight"] = ab["b"]
    return out


def lora_from_state_dict(sd: Mapping[str, torch.Tensor], template: Adapter) -> Adapter:
    """peft/diffusers keys -> an adapter with `template`'s targets, dtypes
    and devices; raises on a shape that differs from the template's."""
    out: Adapter = {}
    for name, ab in template.items():
        a, b = sd[f"unet.{name}.lora_A.weight"], sd[f"unet.{name}.lora_B.weight"]
        if a.shape != ab["a"].shape or b.shape != ab["b"].shape:
            raise ValueError(f"LoRA shape mismatch at {name}: A {tuple(a.shape)}, "
                             f"B {tuple(b.shape)}")
        out[name] = {"a": a.to(ab["a"]), "b": b.to(ab["b"])}
    return out


def lora_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]]) -> Adapter:
    """The JAX package's adapter {"<path>/kernel": {"a": (in, r), "b": (r,
    out)}} -> the port's {module: {"a": (r, in), "b": (out, r)}}."""
    return {_module_key(path[: -len("/kernel")]):
            {"a": _tensor(np.asarray(ab["a"]).T), "b": _tensor(np.asarray(ab["b"]).T)}
            for path, ab in tree.items()}


# ------------------------------------------------- pipeline directories --

# component -> (subdirectory, weights file) of a diffusers pipeline directory
_COMPONENT_FILES = {"unet": ("unet", "diffusion_pytorch_model.safetensors"),
                   "vae": ("vae", "diffusion_pytorch_model.safetensors"),
                   "clip": ("image_encoder", "model.safetensors")}


def load_component_state(component_dir: str, filename: str) -> Dict[str, torch.Tensor]:
    """One component's state dict, following a ``<filename>.index.json``
    shard map where there is one (the format of checkpoints split in
    shards)."""
    path = os.path.join(component_dir, filename)
    index = path + ".index.json"
    if not os.path.exists(index):
        return load_file(path)
    with open(index) as f:
        weight_map = json.load(f)["weight_map"]
    sd: Dict[str, torch.Tensor] = {}
    for shard in sorted(set(weight_map.values())):
        sd.update(load_file(os.path.join(component_dir, shard)))
    if set(sd) != set(weight_map):
        raise ValueError(f"{index}: the shards hold {len(sd)} tensors, the index names "
                         f"{len(weight_map)}")
    return sd


def load_diffusers_checkpoint(root: str, models, components: Sequence[str] = ("unet", "vae",
                                                                              "clip")):
    """Load a diffusers pipeline directory (``unet/``, ``vae/``,
    ``image_encoder/``; plain or shard-indexed safetensors) into `models`'
    networks in place, each with ``load_state_dict(strict=True)`` (the
    UNet through ``load_unet_state``), which casts to the network's dtype
    and device. The CLIP file may hold tensors
    the tower does not (transformers before 4.31 saved the
    ``position_ids`` buffer): they are dropped first, as the JAX package's
    ``clip_transformers_to_flax`` reads only its template's keys; a missing
    key still raises. The UNet and the VAE raise on an unused key, as
    ``diffusers_to_flax`` does. Returns `models`."""
    unknown = set(components) - set(_COMPONENT_FILES)
    if unknown:
        raise ValueError(f"unknown components {sorted(unknown)}")
    for name in components:
        sub, filename = _COMPONENT_FILES[name]
        sd = load_component_state(os.path.join(root, sub), filename)
        net = getattr(models, name)
        if name == "clip":
            held = net.state_dict().keys()
            sd = {k: v for k, v in sd.items() if k in held}
        if name == "unet":
            load_unet_state(net, sd)
        else:
            net.load_state_dict(sd, strict=True)
        del sd
    return models


def load_unet_state(unet: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """A diffusers UNet state dict into `unet`: strict, except that a UNet
    with the Tracklet2Video branch keeps its branch where the file has none
    (the JAX package keeps it at its template values)."""
    missing, unexpected = unet.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not is_branch_key(k)]
    if missing or unexpected:
        raise RuntimeError(f"UNet state dict: missing keys {missing[:5]} ({len(missing)}), "
                           f"unexpected keys {unexpected[:5]} ({len(unexpected)})")
