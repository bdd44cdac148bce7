"""The conv3x3 sites of the main paths at the default 512x320 (latent 40x64),
14 frames, with UNetConfig() and VAEConfig() widths: chip_smoke.py times
and checks the kernel at each, the card tests hold it against its plain
version at each, and the tier-1 plan tests check each site's launch plan.

Also the GEGLU (T, C) shapes of the UNet's four levels: training (batch 14
frames) and generate's CFG pair (28); and the temporal resnet's and
group_norm_silu's shapes with their launches per exact video and per train
step (TRESNET_SITES, GN_SITES), derived from the configs.
"""

from ..core.config import PipelineConfig, TrainConfig, UNetConfig, VAEConfig

# conv3x3 sites of one UNet pass at the default 512x320 (latent 40x64),
# UNetConfig() widths: (H, W, Ci, Co, epilogue, launches per pass). conv1 of
# every resnet adds the time embedding ("preS+post"), conv2 the skip
# ("preS+res"); the up blocks' conv1 reads the concat of the running
# features and a skip. conv_out (Co 4) is declined by supports: 46 convs,
# 45 on the kernel.
UNET_CONV_SITES = [
    (40, 64, 8, 320, "none", 1), (40, 64, 320, 320, "preS+post", 2),
    (40, 64, 320, 320, "preS+res", 5), (40, 64, 960, 320, "preS+post", 1),
    (40, 64, 640, 320, "preS+post", 2),
    (20, 32, 320, 640, "preS+post", 1), (20, 32, 640, 640, "preS+post", 1),
    (20, 32, 640, 640, "preS+res", 5), (20, 32, 1920, 640, "preS+post", 1),
    (20, 32, 1280, 640, "preS+post", 1), (20, 32, 960, 640, "preS+post", 1),
    (10, 16, 640, 1280, "preS+post", 1), (10, 16, 1280, 1280, "preS+post", 1),
    (10, 16, 1280, 1280, "preS+res", 5), (10, 16, 2560, 1280, "preS+post", 2),
    (10, 16, 1920, 1280, "preS+post", 1),
    (5, 8, 1280, 1280, "preS+post", 4), (5, 8, 1280, 1280, "preS+res", 7),
    (5, 8, 2560, 1280, "preS+post", 3),
]
# the train step's dU launches: dy (H, W, Co) -> Ci for every conv whose
# input needs a gradient (not conv_in, not the first L0 resnet, which sit
# before the first trainable temporal layer): (H, W, Co, Ci, launches per step)
UNET_DGRAD_SITES = [
    (40, 64, 320, 320, 5), (40, 64, 320, 960, 1), (40, 64, 320, 640, 2),
    (20, 32, 640, 320, 1), (20, 32, 640, 640, 6), (20, 32, 640, 1920, 1),
    (20, 32, 640, 1280, 1), (20, 32, 640, 960, 1),
    (10, 16, 1280, 640, 1), (10, 16, 1280, 1280, 6), (10, 16, 1280, 2560, 2),
    (10, 16, 1280, 1920, 1),
    (5, 8, 1280, 1280, 11), (5, 8, 1280, 2560, 3),
]
# VAE sites at 512x320 (VAEConfig() widths), per chunk of 8 frames:
# the temporal decoder's spatial resnets (28 launches) and the encoder's
# resnets + conv_out (21 launches; conv_in Ci 3, the decoder's conv_in Ci 4
# and conv_out Co 3 are declined)
VAE_DECODE_SITES = [
    (40, 64, 512, 512, "preS", 5), (40, 64, 512, 512, "preS+res", 5),
    (80, 128, 512, 512, "preS", 3), (80, 128, 512, 512, "preS+res", 3),
    (160, 256, 512, 256, "preS", 1), (160, 256, 256, 256, "preS", 2),
    (160, 256, 256, 256, "preS+res", 3), (320, 512, 256, 128, "preS", 1),
    (320, 512, 128, 128, "preS", 2), (320, 512, 128, 128, "preS+res", 3),
]
VAE_ENCODE_SITES = [
    (320, 512, 128, 128, "preS", 2), (320, 512, 128, 128, "preS+res", 2),
    (160, 256, 128, 256, "preS", 1), (160, 256, 256, 256, "preS", 1),
    (160, 256, 256, 256, "preS+res", 2), (80, 128, 256, 512, "preS", 1),
    (80, 128, 512, 512, "preS", 1), (80, 128, 512, 512, "preS+res", 2),
    (40, 64, 512, 512, "preS", 4), (40, 64, 512, 512, "preS+res", 4),
    (40, 64, 512, 8, "none", 1),
]

# GEGLU (T tokens, C) at the UNet levels: the train step's T = 14 * S, then
# generate's CFG pair, 2T
GEGLU_SHAPES = [(35840, 320), (8960, 640), (2240, 1280), (560, 1280),
                (71680, 320), (17920, 640), (4480, 1280), (1120, 1280)]


def _tresnet_sites():
    """(B, F, S, C, launches per exact video, launches per train step) of
    each of conv_a and conv_b (one each per TemporalResnetBlock call), from
    the default configs: every SpatioTemporalResBlock of the UNet (level i
    of UNetConfig().block_out_channels at the latent's (h / 2^i, w / 2^i):
    layers_per_block down, layers_per_block + 1 up, the mid block's 2 at the
    last level) for generate's 25 CFG passes at batch 2 and the train step's
    forward + "block" remat recompute at batch 1; and the VAE decoder's (2
    in its mid block and layers_per_block + 1 per up block, channels
    reversed, doubling the resolution after each up block but the last) per
    decode chunk of decode_chunk_size frames, the last chunk ragged."""
    unet, vae, pipe, train = UNetConfig(), VAEConfig(), PipelineConfig(), TrainConfig()
    h, w = pipe.height // vae.downsample_factor, pipe.width // vae.downsample_factor
    chs, n = unet.block_out_channels, len(unet.block_out_channels)
    sites = {}
    for i, c in enumerate(chs):
        blocks = unet.layers_per_block + unet.layers_per_block + 1 + (2 if i == n - 1 else 0)
        s = (h >> i) * (w >> i)
        sites[(2, pipe.num_frames, s, c)] = [pipe.num_inference_steps * blocks, 0]
        tb, tf = train.per_device_batch_size, train.num_frames
        sites.setdefault((tb, tf, s, c), [0, 0])[1] += 2 * blocks
    rev = list(reversed(vae.block_out_channels))
    levels = [(0, rev[0], 2)] + [(i, c, vae.layers_per_block + 1) for i, c in enumerate(rev)]
    chunks = [min(pipe.decode_chunk_size, pipe.num_frames - f0)
              for f0 in range(0, pipe.num_frames, pipe.decode_chunk_size)]
    for f in chunks:
        for i, c, blocks in levels:
            sites.setdefault((1, f, (h << i) * (w << i), c), [0, 0])[0] += blocks
    return [(*k, *v) for k, v in sites.items()]


# the temporal resnet's shapes x (B, F, S, C) on the main paths at the
# defaults (512x320, 14 frames): (B, F, S, C, per exact video, per step)
TRESNET_SITES = _tresnet_sites()


def _gn_sites():
    """(x's shape, silu, eps, launches per exact video, launches per train
    step) of group_norm_silu (x channels-last: (N, H, W, C)), from the
    default configs: the norm of every
    spatial and temporal transformer model of the UNet (the levels of the
    CrossAttn blocks, transformer_layers_per_block each: layers_per_block
    down, layers_per_block + 1 up, one in the mid block at the last level;
    no SiLU, eps norm_eps) and its conv_norm_out (SiLU, resnet_eps), for
    generate's 25 CFG passes at batch 2 x frames and the train step's
    forward + "block" remat recompute (the transformer norms, inside the
    remat blocks, run twice; conv_norm_out once); and the VAE's mid-block
    attention norm and conv_norm_out (SiLU), both eps norm_eps: the encoder's
    at the latent's resolution for generate's conditioning image and the
    train step's (batch 1) and for the train step's video in chunks of
    encode_chunk_size frames, the decoder's (its conv_norm_out at full
    resolution, the first block's channels) per decode chunk of
    decode_chunk_size frames, the last chunk ragged."""
    unet, vae, pipe, train = UNetConfig(), VAEConfig(), PipelineConfig(), TrainConfig()
    h, w = pipe.height // vae.downsample_factor, pipe.width // vae.downsample_factor
    chs, n = unet.block_out_channels, len(unet.block_out_channels)
    sites = {}

    def add(shape, silu, eps, video=0, step=0):
        key = (tuple(shape), silu, eps)
        sites.setdefault(key, [0, 0])
        sites[key][0] += video
        sites[key][1] += step

    gen_b = 2 * pipe.num_frames
    train_b = train.per_device_batch_size * train.num_frames
    ups = list(reversed(unet.up_block_types))       # up block of level i
    for i, c in enumerate(chs):
        per_pass = unet.transformer_layers_per_block[i] * (
            unet.layers_per_block * ("CrossAttn" in unet.down_block_types[i])
            + (unet.layers_per_block + 1) * ("CrossAttn" in ups[i]) + (i == n - 1))
        add((gen_b, h >> i, w >> i, c), False, unet.norm_eps,
            video=pipe.num_inference_steps * per_pass)
        add((train_b, h >> i, w >> i, c), False, unet.norm_eps, step=2 * per_pass)
    add((gen_b, h, w, chs[0]), True, unet.resnet_eps, video=pipe.num_inference_steps)
    add((train_b, h, w, chs[0]), True, unet.resnet_eps, step=1)
    top = vae.block_out_channels[-1]
    chunks = lambda frames, size: [min(size, frames - f0) for f0 in range(0, frames, size)]
    for f, video, step in ([(1, 1, 1)] + [(f, 0, 1) for f in chunks(train_b,
                                                                    train.encode_chunk_size)]):
        for silu in (False, True):
            add((f, h, w, top), silu, vae.norm_eps, video=video, step=step)
    for f in chunks(pipe.num_frames, pipe.decode_chunk_size):
        add((f, h, w, top), False, vae.norm_eps, video=1)
        add((f, pipe.height, pipe.width, vae.block_out_channels[0]), True, vae.norm_eps,
            video=1)
    return [(*k, *v) for k, v in sites.items()]


# group_norm_silu's shapes on the main paths at the defaults (512x320, 14
# frames): (shape, silu, eps, per exact video, per step)
GN_SITES = _gn_sites()


def _flash_bwd_sites():
    """flash_attention_bwd calls per train step by tokens S, per scope, from
    the default configs: one per spatial self-attention whose inputs need a
    gradient (the transformer models of each level, as in _gn_sites, at the
    train latent's h / 2^i x w / 2^i tokens). The 'lora' scope trains
    adapters on every attention, so every site; the 'temporal' scope none
    before the first temporal block, so not the first transformer model's
    spatial self-attention."""
    unet, vae, train = UNetConfig(), VAEConfig(), TrainConfig()
    h, w = train.height // vae.downsample_factor, train.width // vae.downsample_factor
    n = len(unet.block_out_channels)
    ups = list(reversed(unet.up_block_types))
    lora = {}
    for i in range(n):
        models = unet.transformer_layers_per_block[i] * (
            unet.layers_per_block * ("CrossAttn" in unet.down_block_types[i])
            + (unet.layers_per_block + 1) * ("CrossAttn" in ups[i]) + (i == n - 1))
        if models:
            lora[(h >> i) * (w >> i)] = models
    temporal = dict(lora)
    temporal[next(iter(lora))] -= 1
    return {"lora": lora, "temporal": {s: c for s, c in temporal.items() if c}}


# flash_attention_bwd calls per train step by tokens S at the defaults, per
# scope ('lora', 'temporal')
FLASH_BWD_SITES = _flash_bwd_sites()
