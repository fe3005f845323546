"""Batched device pipelines: where the throughput lives.

  JpegBatchPipeline — decode -> resize -> {uint8|normalize|re-encode}
  TrainingInput     — deterministic resumable training-input iterator
  augment           — device-side jitter/cutout/mixup (config 5)
  prefetch          — double-buffered host->device overlap
"""

from ..runtime.compile_cache import enable as _enable_compile_cache

# the pipelines jit large graphs; a persistent cache makes their
# compiles one-time costs shared across processes
_enable_compile_cache()

from .image_batch import ImageBatchPipeline  # noqa: F401
from .jpeg_batch import JpegBatchPipeline, entropy_decode, signature  # noqa: F401
from .prefetch import map_prefetch, prefetch  # noqa: F401
from .training import TrainingInput  # noqa: F401
from . import augment  # noqa: F401
from .serving import DynamicBatcher, stream_best  # noqa: F401
from .png_batch import PngBatchPipeline  # noqa: F401
from .tiff_batch import TiffBatchPipeline  # noqa: F401
