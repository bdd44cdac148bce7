"""The conv3x3 sites of the main paths at the default 512x320 (latent 40x64),
14 frames, with UNetConfig() and VAEConfig() widths: chip_smoke.py times
and checks the kernel at each, the card tests hold it against its plain
version at each, and the tier-1 plan tests check each site's launch plan.

Also the GEGLU (T, C) shapes of the UNet's four levels: training (batch 14
frames) and generate's CFG pair (28).
"""

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
