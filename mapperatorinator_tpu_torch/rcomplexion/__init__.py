from .data import RcomplexionDataset, create_sequences, tokenize_events
from .parser import RParser
from .vocab import RTokenizer

__all__ = ["RTokenizer", "RParser", "RcomplexionDataset", "create_sequences", "tokenize_events"]
