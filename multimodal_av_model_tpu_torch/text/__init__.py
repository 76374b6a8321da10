from .korean import KoreanSyllableVocab
from .tokenizer import CharTokenizer

__all__ = ["CharTokenizer", "KoreanSyllableVocab"]
