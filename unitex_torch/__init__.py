"""unitex_torch — the PyTorch/CUDA port of unitex_tpu for one NVIDIA H100.

Top-level names load lazily, so ``import unitex_torch`` touches no device
and builds nothing."""


def __getattr__(name):
    if name in ("CustomRGBTextureFullPipeline", "RGBTextureFullPipeline"):
        from . import pipeline

        return getattr(pipeline, name)
    if name == "PipelineConfig":
        from .config import PipelineConfig

        return PipelineConfig
    raise AttributeError(name)
