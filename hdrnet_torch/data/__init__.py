"""The port's input pipelines (its own copy of ``hdrnet_tpu.data``): the
host pipeline, with numpy image operations in place of the JAX package's
C++ library, and the device-resident dataset in
:mod:`hdrnet_torch.data.device`."""

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
