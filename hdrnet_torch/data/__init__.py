"""The port's host input pipeline (its own copy of ``hdrnet_tpu.data``,
with numpy image operations in place of the JAX package's C++ library)."""

from hdrnet_torch.data.pipeline import (
    PIPELINES,
    DataPipeline,
    HDRpDataPipeline,
    ImageFilesDataPipeline,
    StyleTransferDataPipeline,
    UnsharpMaskDataPipeline,
    make_pipeline,
)
from hdrnet_torch.data.records import ShardReader, ShardWriter

__all__ = [
    'PIPELINES', 'DataPipeline', 'ImageFilesDataPipeline',
    'HDRpDataPipeline', 'StyleTransferDataPipeline',
    'UnsharpMaskDataPipeline', 'make_pipeline', 'ShardReader', 'ShardWriter',
]
