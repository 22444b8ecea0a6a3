"""strugatzki_tpu — accelerator audio feature extraction and similarity analysis.

A from-scratch JAX/XLA framework with the capabilities of the
Strugatzki reference (phdoerfler/Strugatzki): MFCC + perceptual-loudness
feature extraction, database correlation matching (punch-in/out search with
loudness-boost estimation), novelty segmentation, self-/cross-similarity
matrices and feature-database statistics — with the DSP front-end and all
sliding-window correlation math implemented as batched device ops instead of an
scsynth subprocess and single-threaded scalar loops.

On-disk surface (float32 AIFC feature files, XML meta sidecars,
``feat_norms.aif``) is bit-compatible with the reference so existing feature
databases remain valid.
"""

from .config import (NORMALIZE_NAME, Break, ChannelsBehavior, ColorScheme,
                     CorrelationConfig, CrossSimilarityConfig,
                     ExtractionConfig, Match, Punch, SegmentationConfig,
                     SelfSimilarityConfig)
from .runtime.processor import Aborted, Processor, Progress, Result
from .span import Span

__version__ = "0.1.0"

__all__ = [
    "NORMALIZE_NAME",
    "Span", "Punch", "Match", "Break",
    "ChannelsBehavior", "ColorScheme",
    "ExtractionConfig", "CorrelationConfig", "SegmentationConfig",
    "SelfSimilarityConfig", "CrossSimilarityConfig",
    "Aborted", "Processor", "Progress", "Result",
    "FeatureExtraction", "FeatureCorrelation", "FeatureSegmentation",
    "SelfSimilarity", "CrossSimilarity", "FeatureStats",
    "FeatureDatabase", "extract_features",
]


def __getattr__(name):
    # Lazy imports: the analysis factories pull in jax; keep config/XML usable
    # without touching the accelerator runtime.
    if name == "FeatureExtraction":
        from .analysis.extraction import FeatureExtraction
        return FeatureExtraction
    if name == "FeatureCorrelation":
        from .analysis.correlation import FeatureCorrelation
        return FeatureCorrelation
    if name == "FeatureSegmentation":
        from .analysis.segmentation import FeatureSegmentation
        return FeatureSegmentation
    if name == "SelfSimilarity":
        from .analysis.self_similarity import SelfSimilarity
        return SelfSimilarity
    if name == "CrossSimilarity":
        from .analysis.cross_similarity import CrossSimilarity
        return CrossSimilarity
    if name == "FeatureStats":
        from .analysis.feature_stats import FeatureStats
        return FeatureStats
    if name == "FeatureDatabase":
        from .parallel.database import FeatureDatabase
        return FeatureDatabase
    if name == "extract_features":
        from .dsp.frontend import extract_features
        return extract_features
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
