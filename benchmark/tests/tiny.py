"""A copy of the benchmark's data at TINY sizes, for CPU tests: the two
cells' configurations cut to two UNet levels, a two-level VAE and a two-layer
CLIP, their traffic at 32x32, 3 frames, and the cells' own limits. The
generation cell is withdrawn from BENCHMARK.json (``benchmark/withdrawn/``)
and tested all the same."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DATA = REPO / "benchmark"
CELLS = {"xt-576p-gen": "tiny-gen", "img2vid-320p-train": "tiny-train"}


def full_spec() -> dict:
    """BENCHMARK.json with the entries of the withdrawn cells
    (``benchmark/withdrawn/<cell>.json``) merged back in."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for path in sorted((DATA / "withdrawn").glob("*.json")):
        extra = json.loads(path.read_text())
        spec["configs"] += extra["configs"]
        spec["workloads"] += extra["workloads"]
        for group in ("end_to_end", "per_layer"):
            have = {m["name"]: m for m in spec[group]}
            for m in extra[group]:
                if m["name"] in have:
                    if "workloads" in have[m["name"]]:
                        have[m["name"]]["workloads"] += m["workloads"]
                else:
                    spec[group].append(m)
    return spec


def tiny_config(cfg: dict, dtype: str = "bfloat16") -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg["dtype"] = dtype
    cfg["unet"].update(
        block_out_channels=[32, 64], num_attention_heads=[2, 4], cross_attention_dim=32,
        addition_time_embed_dim=8, projection_class_embeddings_input_dim=24, layers_per_block=1,
        down_block_types=["CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"],
        up_block_types=["UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal"], num_frames=3)
    cfg["vae"].update(block_out_channels=[32, 64], layers_per_block=1)
    cfg["image_encoder"].update(image_size=28, patch_size=14, hidden_size=32,
                                num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                                projection_dim=32)
    return cfg


def tiny_data(tmp: Path, dtype: str = "bfloat16"):
    """(spec, data_dir): a copy of the benchmark's files under `tmp` with the
    cells ``tiny-gen`` and ``tiny-train`` beside the real ones, reported by
    the real cells' metrics and held to their limits."""
    d = tmp / "benchmark"
    shutil.copytree(DATA, d, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((d / "configs" / "svd-img2vid-xt.json").read_text())
    (d / "configs" / "tiny.json").write_text(json.dumps(tiny_config(cfg, dtype)))
    gen = json.loads((d / "traffic" / "gen-576p-25f.json").read_text())
    gen["pipeline"].update(height=32, width=32, num_frames=3, num_inference_steps=2,
                           decode_chunk_size=2)
    gen["pool"] = 2
    (d / "traffic" / "tiny-gen.json").write_text(json.dumps(gen))
    train = json.loads((d / "traffic" / "train-temporal-320p.json").read_text())
    train["train"].update(height=32, width=32, num_frames=3, learning_rate=1e-3)
    train["pool"] = 4
    (d / "traffic" / "tiny-train.json").write_text(json.dumps(train))
    spec = full_spec()
    spec["configs"].append({"name": "tiny", "source": "TINY", "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "CPU tests"})
    for real, tiny in CELLS.items():
        cell = next(c for c in spec["workloads"] if c["name"] == real)
        spec["workloads"].append(dict(cell, name=tiny, config="tiny", traffic=tiny))
        shutil.copy(d / "limits" / f"{real}.json", d / "limits" / f"{tiny}.json")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [CELLS[w] for w in m["workloads"] if w in CELLS]
    return spec, d
