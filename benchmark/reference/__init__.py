"""Plain NumPy reference answers for the served routes.

It works every answer out again from the reads that the benchmark
generated, through a table of the reads' k-mer windows, and imports
nothing of the program under test, of the JAX package or of JAX.
"""

from .answers import Expected, expected_answers, kmer_keys, revcomp

__all__ = ["Expected", "expected_answers", "kmer_keys", "revcomp"]
