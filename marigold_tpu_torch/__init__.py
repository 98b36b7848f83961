"""marigold_tpu_torch — the PyTorch and CUDA port of marigold_tpu for NVIDIA
Hopper GPUs.

Same public API as `marigold_tpu` for the slice ported so far (depth
inference):

    from marigold_tpu_torch import MarigoldDepthPipeline
    pipe = MarigoldDepthPipeline.from_pretrained(ckpt_dir, device="cuda")
    depth = pipe(image_uint8, denoising_steps=4, seed=0).depth_np

It imports torch and never JAX or `marigold_tpu`.
"""

__version__ = "0.1.0"

from marigold_tpu_torch.pipelines.depth import (
    MarigoldDepthOutput,
    MarigoldDepthPipeline,
)

MarigoldPipeline = MarigoldDepthPipeline

__all__ = ["MarigoldDepthPipeline", "MarigoldDepthOutput", "MarigoldPipeline"]
