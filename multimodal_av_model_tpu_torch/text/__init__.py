from .korean import KoreanSyllableVocab
from .tokenizer import CharTokenizer, Tokenizer

__all__ = ["CharTokenizer", "KoreanSyllableVocab", "Tokenizer"]
