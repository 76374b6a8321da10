from .tokenizer import CharTokenizer

__all__ = ["CharTokenizer"]
