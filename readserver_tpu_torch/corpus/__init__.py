"""Host-side corpus tooling (the analog of the reference's L0 layer).

The reference's ``scripts/`` Perl pipeline extracts, cleans and RLO-sorts
reads from CRAM per sample (SURVEY.md §1 L0, §2.1).  Here: deterministic
read simulators for the five benchmark configs (BASELINE.json configs 1–5),
FASTA/FASTQ ingest, and a normalizer that enforces the ACGT alphabet.
"""

from readserver_tpu_torch.corpus.simulate import (
    CONFIGS,
    SimulatedCorpus,
    random_genome,
    simulate_config,
    simulate_reads,
)
from readserver_tpu_torch.corpus.io import (
    normalize_read,
    rlo_sort,
    read_fasta,
    read_fastq,
    write_fasta,
)

__all__ = [
    "CONFIGS",
    "SimulatedCorpus",
    "random_genome",
    "simulate_reads",
    "simulate_config",
    "read_fasta",
    "read_fastq",
    "write_fasta",
    "normalize_read",
    "rlo_sort",
]
