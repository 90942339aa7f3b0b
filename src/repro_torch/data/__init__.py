"""repro_torch.data (counterpart of ``repro.data``): the synthetic and
memory-mapped token sources and their prefetch thread."""
from .pipeline import MemmapCorpus, Prefetcher, SyntheticLM

__all__ = ["MemmapCorpus", "Prefetcher", "SyntheticLM"]
