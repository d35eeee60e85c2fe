"""Evaluation of the port: perplexity over a token stream."""

from .perplexity import perplexity, perplexity_of_gguf, sequence_nll

__all__ = ["perplexity", "perplexity_of_gguf", "sequence_nll"]
