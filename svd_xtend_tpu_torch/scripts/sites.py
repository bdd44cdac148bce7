"""The conv3x3 sites of the main paths at the default 512x320 (latent 40x64),
14 frames, with UNetConfig() and VAEConfig() widths: chip_smoke.py times
and checks the kernel at each, the card tests hold it against its plain
version at each, and the tier-1 plan tests check each site's launch plan.
The up blocks' conv1 sites read their input as two parts (the running
features and a skip, whose concat is never built); Ci is the sum. The
upsample kernel's sites (UPSAMPLE_SITES): the inputs of the UNet's three
upsamplers and the VAE decoder's three, with their launches per exact
video and per train step, derived from the configs; and generate's at two
portrait resolutions (PORTRAIT_UPSAMPLE_SHAPES).

Also the GEGLU (T, C) shapes of the UNet's four levels: training (batch 14
frames) and generate's CFG pair (28); the temporal resnet's and
group_norm_silu's shapes with their launches per exact video and per train
step (TRESNET_SITES, GN_SITES) and group_norm_fold's per exact video
(FOLD_SITES), derived from the configs; and the flash
kernels' calls by (tokens S_q, keys S_kv): per UNet pass at any size, with
or without the Tracklet2Video gated attentions (``flash_calls_per_pass``),
and per train step by scope (FLASH_BWD_SITES).

The int8 modes (``ops/quant.py``): INT8_CONV_SITES and INT8_VAE_CONV_SITES,
the Conv3x3 calls of a UNet pass and of a decode chunk (the conv3x3 tables
above plus the edge convs the bf16 kernel declines), and INT8_DENSE_SITES,
the QLinear calls of a CFG UNet pass by (rows, K, N), derived from the
configs; INT8_GATE_SITES, the feed-forwards' net.2 calls, whose quantise
takes the gate as its prologue; INT8_QUANTISE_SITES, the quantise calls of
those QLinear sites by input shape; and INT8_QUANTIZE_CALLS, every quantise
call of a pass.
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
# before the first trainable temporal layer), and for the three upsamplers
# (dy at their output resolution; dX is dU's 2x2 sums): (H, W, Co, Ci,
# launches per step)
UNET_DGRAD_SITES = [
    (40, 64, 320, 320, 5), (40, 64, 320, 960, 1), (40, 64, 320, 640, 2),
    (40, 64, 640, 640, 1),
    (20, 32, 640, 320, 1), (20, 32, 640, 640, 6), (20, 32, 640, 1920, 1),
    (20, 32, 640, 1280, 1), (20, 32, 640, 960, 1), (20, 32, 1280, 1280, 1),
    (10, 16, 1280, 640, 1), (10, 16, 1280, 1280, 7), (10, 16, 1280, 2560, 2),
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


def _up_split_sites():
    """(H, W, C1, C2, Co) of every up-block resnet's conv1 in the order a
    pass runs them, from UNetConfig(): its input is the running features
    (C1: the previous block's channels for the first resnet, the block's
    own after) and a skip (C2: the level's channels, the last one the
    next-higher level's), two parts of a concat that is never built."""
    unet, vae, pipe = UNetConfig(), VAEConfig(), PipelineConfig()
    h, w = pipe.height // vae.downsample_factor, pipe.width // vae.downsample_factor
    rev, n = list(reversed(unet.block_out_channels)), len(unet.block_out_channels)
    out, prev = [], rev[0]
    for i in range(n):
        level = n - 1 - i
        skips = [rev[i]] * unet.layers_per_block + [rev[min(i + 1, n - 1)]]
        for j, c2 in enumerate(skips):
            out.append((h >> level, w >> level, prev if j == 0 else rev[i], c2, rev[i]))
        prev = rev[i]
    return out


# the up blocks' conv1 sites, (H, W, C1, C2, Co), one launch each a pass: the
# "preS+post" sites of UNET_CONV_SITES whose Ci is C1 + C2
UP_SPLIT_SITES = _up_split_sites()


def _upsample_sites(height=None, width=None):
    """(N, H, W, C, launches per exact video, launches per train step) of
    the upsample kernel (Upsample2D's input (N, H, W, C), C -> C), from the
    default configs (at height x width where given): the upsampler that ends every UNet up block but the
    last (up block i at level n - 1 - i, with the reversed block channels),
    at generate's CFG batch 2 x frames once a pass for 25 passes, and at the
    train step's batch x frames twice a step (the forward and the "block"
    remat recompute of the up blocks); and the VAE decoder's, ending every
    up block but the last (reversed channels, the latent's resolution
    doubling per block), once per decode chunk of decode_chunk_size frames,
    the last chunk ragged."""
    unet, vae, pipe, train = UNetConfig(), VAEConfig(), PipelineConfig(), TrainConfig()
    h = (height or pipe.height) // vae.downsample_factor
    w = (width or pipe.width) // vae.downsample_factor
    rev, n = list(reversed(unet.block_out_channels)), len(unet.block_out_channels)
    out = []
    for batch, video, step in ((2 * pipe.num_frames, pipe.num_inference_steps, 0),
                               (train.per_device_batch_size * train.num_frames, 0, 2)):
        out += [(batch, h >> (n - 1 - i), w >> (n - 1 - i), rev[i], video, step)
                for i in range(n - 1)]
    vae_rev = list(reversed(vae.block_out_channels))
    chunks = [min(pipe.decode_chunk_size, pipe.num_frames - f0)
              for f0 in range(0, pipe.num_frames, pipe.decode_chunk_size)]
    for f in dict.fromkeys(chunks):
        out += [(f, h << i, w << i, vae_rev[i], chunks.count(f), 0)
                for i in range(len(vae_rev) - 1)]
    return out


# the upsample kernel's inputs (N, H, W, C) on the main paths at the defaults
# (512x320, 14 frames): (N, H, W, C, per exact video, per step)
UPSAMPLE_SITES = _upsample_sites()

# generate's upsample inputs (N, H, W, C) in portrait, 512x320 and 1024x576
# (height x width): widths whose levels (UNet 5, 10, 20 and 9, 18, 36; VAE
# 40, 80, 160 and 72, 144, 288) neither divide 64 nor are multiples of it,
# so that the kernel's epilogue writes a warpgroup's rows in several stores
PORTRAIT_UPSAMPLE_SHAPES = sorted({st[:4] for hw in ((512, 320), (1024, 576))
                                   for st in _upsample_sites(*hw) if st[4]})

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


def _fold_sites():
    """(x's shape, launches per exact video) of group_norm_fold, from the
    tables above: the norm1 of every GN-fold conv3x3 (an epilogue starting
    with "preS") of generate's 25 CFG passes (N = 2 x frames; the up blocks'
    two-part folds by their total width), of the conditioning image's encode
    (N = 1) and of each decode chunk (N = its frames), and norm1 of every
    temporal resnet (TRESNET_SITES). norm2 of the temporal resnet folds in
    kernel A and launches nothing."""
    pipe = PipelineConfig()
    passes, n = pipe.num_inference_steps, 2 * pipe.num_frames
    chunks = [min(pipe.decode_chunk_size, pipe.num_frames - f0)
              for f0 in range(0, pipe.num_frames, pipe.decode_chunk_size)]
    sites = {}

    def add(shape, launches):
        sites[shape] = sites.get(shape, 0) + launches

    for batch, runs, table in ([(n, passes, UNET_CONV_SITES), (1, 1, VAE_ENCODE_SITES)]
                               + [(f, 1, VAE_DECODE_SITES) for f in chunks]):
        for h, w, ci, _, epi, per in table:
            if epi.startswith("preS"):
                add((batch, h, w, ci), runs * per)
    for b, f, s, c, video, _ in TRESNET_SITES:
        if video:
            add((b, f, s, c), video)
    return sorted(sites.items())


# group_norm_fold's shapes per exact video at the defaults: (shape, launches)
FOLD_SITES = _fold_sites()


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


def _transformer_models(level: int) -> dict:
    """The UNet's transformer models at resolution level `level`, by where
    they sit: {"down": n, "up": n, "mid": n} (UNetConfig() blocks)."""
    unet = UNetConfig()
    n = len(unet.block_out_channels)
    ups = list(reversed(unet.up_block_types))       # up block of level i
    t = unet.transformer_layers_per_block[level]
    return {"down": t * unet.layers_per_block * ("CrossAttn" in unet.down_block_types[level]),
            "up": t * (unet.layers_per_block + 1) * ("CrossAttn" in ups[level]),
            "mid": t * (level == n - 1)}


def flash_calls_per_pass(height: int, width: int, boxes: int = 0, depth=None) -> dict:
    """Flash forward calls of one UNet pass over a (height, width) video by
    (S_q, S_kv): every transformer model's spatial self-attention (S, S) at
    its level's h / 2^i x w / 2^i latent tokens and, with `boxes` box tokens
    a frame, its Tracklet2Video gated attention (S, S + boxes). `depth`:
    a DeepCache shallow pass, which runs the down and up blocks of levels
    [0, depth) and not the mid block."""
    vae = VAEConfig()
    h, w = height // vae.downsample_factor, width // vae.downsample_factor
    calls = {}
    for i in range(len(UNetConfig().block_out_channels)):
        m = _transformer_models(i)
        models = m["down"] + m["up"] + m["mid"] if depth is None else (
            m["down"] + m["up"] if i < depth else 0)
        s = (h >> i) * (w >> i)
        for key in ([(s, s)] + ([(s, s + boxes)] if boxes else [])):
            if models:
                calls[key] = calls.get(key, 0) + models
    return calls


def _flash_bwd_sites():
    """flash_attention_bwd calls per train step by (S_q, S_kv), per scope,
    from the default configs: one per attention whose inputs need a
    gradient, at the train latent's h / 2^i x w / 2^i tokens. The 'lora'
    scope trains adapters on every attention, so every spatial
    self-attention; the 'temporal' scope none before the first temporal
    block, so not the first transformer model's; the 'tracklet' scope the
    same self-attentions (its first trainable layer, the first gated
    attention, follows the first one) and every gated attention (S, S +
    max_boxes)."""
    train = TrainConfig()
    lora = flash_calls_per_pass(train.height, train.width)
    temporal = dict(lora)
    temporal[next(iter(lora))] -= 1
    temporal = {k: c for k, c in temporal.items() if c}
    gated = {(s, s + train.max_boxes): c for (s, _), c in lora.items()}
    return {"lora": lora, "temporal": temporal, "tracklet": {**temporal, **gated}}


# flash_attention_bwd calls per train step by (S_q, S_kv) at the defaults, per
# scope ('lora', 'temporal', 'tracklet')
FLASH_BWD_SITES = _flash_bwd_sites()


# the int8 GEMM's conv sites (every Conv3x3 is an int8 site in int8 mode):
# the UNet pass's 45 above and its conv_out (Co 4), 46; a decode chunk's 28
# and the decoder's conv_in (Ci 4) and conv_out (Co 3), 30. (H, W, Ci, Co,
# epilogue, launches per pass / chunk)
INT8_CONV_SITES = UNET_CONV_SITES + [(40, 64, 320, 4, "none", 1)]
INT8_VAE_CONV_SITES = VAE_DECODE_SITES + [(40, 64, 4, 512, "none", 1),
                                          (320, 512, 128, 3, "none", 1)]


def _models_by_level(unet: UNetConfig):
    """(level, channels, transformer models at the level) of a UNet pass."""
    n, ups = len(unet.block_out_channels), list(reversed(unet.up_block_types))
    for i, c in enumerate(unet.block_out_channels):
        t = unet.transformer_layers_per_block[i]
        yield i, c, t * (unet.layers_per_block * ("CrossAttn" in unet.down_block_types[i])
                         + (unet.layers_per_block + 1) * ("CrossAttn" in ups[i])
                         + (i == n - 1))


def _pass_rows(unet, height, width, frames, batch, downsample):
    pipe = PipelineConfig()
    ds = downsample or VAEConfig().downsample_factor
    h, w = (height or pipe.height) // ds, (width or pipe.width) // ds
    return batch * (frames or pipe.num_frames), h, w


def int8_dense_sites(unet: UNetConfig = None, height: int = None, width: int = None,
                     frames: int = None, batch: int = 2, downsample: int = None):
    """(rows, K, N, launches per pass) of the QLinear calls of one UNet pass
    over `batch` samples of `frames` frames at height x width (the default
    512x320, 14 frames; batch 2: the CFG pair, 1: a cond-only pass). Per
    transformer model at a level of C channels and S tokens a frame (rows R
    = batch·frames·S): proj_in, proj_out and the spatial and frame
    self-attentions' q, k, v, out (R, C, C) x 10; the three feed-forwards'
    net.0.proj (R, C, 8C) and net.2 (R, 4C, C); the spatial cross-attention's
    to_v on the one CLIP token a frame (batch·frames, D, C) and its to_out
    (batch·frames, C, C); the frame cross-attention's on one token a sample
    (batch, D, C), (batch, C, C)."""
    unet = unet or UNetConfig()
    bf, h, w = _pass_rows(unet, height, width, frames, batch, downsample)
    d = unet.cross_attention_dim
    sites = {}
    for i, c, models in _models_by_level(unet):
        r = bf * (h >> i) * (w >> i)
        for key, k in (((r, c, c), 10), ((r, c, 8 * c), 3), ((r, 4 * c, c), 3),
                       ((bf, d, c), 1), ((bf, c, c), 1), ((batch, d, c), 1), ((batch, c, c), 1)):
            if models:
                sites[key] = sites.get(key, 0) + k * models
    return sorted((k + (m,) for k, m in sites.items()), reverse=True)


def int8_gate_sites(unet: UNetConfig = None, height: int = None, width: int = None,
                    frames: int = None, batch: int = 2, downsample: int = None):
    """(rows, 8C, 4C, launches per pass) of the feed-forwards' net.2 calls,
    whose quantise reads net.0.proj's (rows, 8C) output and computes the
    gate h·gelu_tanh(g) as it reads: three a transformer model."""
    unet = unet or UNetConfig()
    bf, h, w = _pass_rows(unet, height, width, frames, batch, downsample)
    sites = {}
    for i, c, models in _models_by_level(unet):
        if models:
            key = (bf * (h >> i) * (w >> i), 8 * c, 4 * c)
            sites[key] = sites.get(key, 0) + 3 * models
    return sorted((k + (m,) for k, m in sites.items()), reverse=True)


def int8_conv_calls(unet: UNetConfig = None) -> int:
    """The Conv3x3 calls of a UNet pass: conv_in, conv_out and two a
    spatial resnet (layers_per_block a down block, one more an up block,
    1 + the last level's transformer layers in the mid block)."""
    unet = unet or UNetConfig()
    n = len(unet.block_out_channels)
    resnets = (n * (2 * unet.layers_per_block + 1) + 1
               + unet.transformer_layers_per_block[-1])
    return 2 + 2 * resnets


def int8_quantise_sites(unet: UNetConfig = None, height: int = None, width: int = None,
                        frames: int = None, batch: int = 2, downsample: int = None):
    """(rows, input width, code width, calls per pass) of the quantise calls
    at the QLinear sites of one UNet pass (int8_dense_sites' shapes): one a
    call, but for the spatial and frame self-attentions' to_k and to_v,
    which read to_q's codes (4 fewer a transformer model), and for net.2,
    whose quantise reads net.0.proj's (rows, 8C) output (the gate: input
    width twice the code width)."""
    unet = unet or UNetConfig()
    bf, h, w = _pass_rows(unet, height, width, frames, batch, downsample)
    d = unet.cross_attention_dim
    sites = {}
    for i, c, models in _models_by_level(unet):
        r = bf * (h >> i) * (w >> i)
        for key, k in (((r, c, c), 6 + 3), ((r, 8 * c, 4 * c), 3), ((bf, d, d), 1),
                       ((bf, c, c), 1), ((batch, d, d), 1), ((batch, c, c), 1)):
            if models:
                sites[key] = sites.get(key, 0) + k * models
    return sorted((k + (m,) for k, m in sites.items()), reverse=True)


def int8_quantize_calls(unet: UNetConfig = None, **shape) -> int:
    """The quantise calls of a UNet pass (CFG pair or cond-only alike): one a
    Conv3x3 and int8_quantise_sites' (302 at the defaults: 46 convs and 320
    QLinears, less the 64 self-attention to_k and to_v that share to_q's
    codes)."""
    return int8_conv_calls(unet) + sum(st[3] for st in int8_quantise_sites(unet, **shape))


INT8_DENSE_SITES = int8_dense_sites()
INT8_GATE_SITES = int8_gate_sites()
INT8_QUANTISE_SITES = int8_quantise_sites()
INT8_QUANTIZE_CALLS = int8_quantize_calls()
