"""Host-side corpus tooling: the deterministic read simulators.

The port carries only ``simulate`` so far; FASTA/FASTQ/BAM ingest stays in
the JAX package until the port's CLI needs it.
"""

from readserver_tpu_torch.corpus.simulate import (
    CONFIGS,
    SimulatedCorpus,
    random_genome,
    simulate_config,
    simulate_reads,
)

__all__ = [
    "CONFIGS",
    "SimulatedCorpus",
    "random_genome",
    "simulate_reads",
    "simulate_config",
]
