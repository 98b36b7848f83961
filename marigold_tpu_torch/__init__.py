"""marigold_tpu_torch — the PyTorch and CUDA port of marigold_tpu for NVIDIA
Hopper GPUs.

Same public API as `marigold_tpu` for the slices ported so far: depth,
normals and IID inference (any ensemble size; LCM depth checkpoints too)
and depth fine-tuning:

    from marigold_tpu_torch import MarigoldDepthPipeline
    pipe = MarigoldDepthPipeline.from_pretrained(ckpt_dir)  # the CUDA device
    out = pipe(image_uint8, denoising_steps=4, ensemble_size=10, seed=0)
    out.depth_np, out.uncertainty

    from marigold_tpu_torch import MarigoldNormalsPipeline, MarigoldIIDPipeline
    MarigoldNormalsPipeline.from_pretrained(ckpt)(image).normals_np
    MarigoldIIDPipeline.from_pretrained(ckpt)(image)["albedo"].array

    from marigold_tpu_torch.train.trainer import MarigoldDepthTrainer
    MarigoldDepthTrainer(cfg, sd2_pipe, batches, ...).train()

It imports torch and never JAX or `marigold_tpu`.
"""

__version__ = "0.1.0"

from marigold_tpu_torch.pipelines.depth import (
    MarigoldDepthOutput,
    MarigoldDepthPipeline,
)
from marigold_tpu_torch.pipelines.iid import MarigoldIIDOutput, MarigoldIIDPipeline
from marigold_tpu_torch.pipelines.normals import (
    MarigoldNormalsOutput,
    MarigoldNormalsPipeline,
)

MarigoldPipeline = MarigoldDepthPipeline

__all__ = [
    "MarigoldDepthPipeline",
    "MarigoldDepthOutput",
    "MarigoldNormalsPipeline",
    "MarigoldNormalsOutput",
    "MarigoldIIDPipeline",
    "MarigoldIIDOutput",
    "MarigoldPipeline",
]
