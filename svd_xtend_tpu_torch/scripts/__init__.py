"""The port's counterparts of the JAX package's TPU probe scripts, run on the
card as ``python -m svd_xtend_tpu_torch.scripts.<name>``.

- ``microbench_flash_headslice``: the flash forward on the packed layout
  against the head-major entry point and the head-sliced one;
- ``microbench_flash_variants``: the four softmax organisations of the
  flash forward on the head-major (B·H, S, 64) layout;
- ``probe_int8_flash``: the dependent QKᵀ→PV chain in bf16 and in int8
  with dynamic quantisation;

``probe_nvjpeg``, nvJPEG's decode of the frame fixture against libjpeg's
(why the frame loader carries its own decoder for machines without
libjpeg);

``bench_flash_forward``, the flash forward's device time at the UNet's
shapes and the variants' per mode, for comparing builds of the kernels;
``bench_gemm_plans``, conv3x3's and GEGLU's device time under each launch
plan of the shared GEMM mainloop; ``bench_frame_gn``, the frame attention's
and GroupNorm's device time at every shape of the main paths, beside
another tree's; and ``sites``, the conv3x3 sites and GEGLU
shapes of the main paths (chip_smoke.py, the card tests and the plan tests
share them).
"""

import subprocess

import torch


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    require_card()
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean ms of `fn` over `iters` launches after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device ms per call of `fn`: `iters` calls captured in one CUDA graph,
    replayed `replays` times between CUDA events. Unlike cuda_ms's host
    loop, this does not read the wrapper's host time where a launch is
    shorter."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def require_card() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("this probe runs on a CUDA card only")
    return torch.device("cuda")
