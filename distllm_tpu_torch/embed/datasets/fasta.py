"""FASTA dataset for protein sequences (copy of
``distllm_tpu.embed.datasets.fasta``): uppercased sequences, metadata
``{tags, paths}``."""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from pathlib import Path

from distllm_tpu_torch.embed.datasets.base import TextCorpus
from distllm_tpu_torch.utils import BaseConfig


@dataclass
class Sequence:
    sequence: str
    tag: str


def read_fasta(fasta_file: 'str | Path') -> list[Sequence]:
    """Parse a FASTA file into (uppercased sequence, tag) records; a
    record's sequence lines are joined, an empty record is dropped."""
    text = Path(fasta_file).read_text()
    entries = []
    for block in re.split(r'^>', text, flags=re.MULTILINE):
        block = block.strip()
        if not block:
            continue
        lines = block.splitlines()
        tag = lines[0].strip()
        seq = ''.join(line.strip() for line in lines[1:]).upper()
        if seq:
            entries.append(Sequence(sequence=seq, tag=tag))
    return entries


def write_fasta(sequences: list[Sequence], fasta_file: 'str | Path') -> None:
    with open(fasta_file, 'w') as fh:
        for record in sequences:
            fh.write(f'>{record.tag}\n{record.sequence}\n')


@dataclasses.dataclass
class FastaDatasetConfig(BaseConfig):
    name: str = 'fasta'
    batch_size: int = 8


class FastaDataset:
    def __init__(self, config: FastaDatasetConfig) -> None:
        self.config = config

    def read(self, data_file: 'str | Path') -> TextCorpus:
        entries = read_fasta(data_file)
        return TextCorpus(
            texts=[e.sequence for e in entries],
            metadata=[{'tags': e.tag, 'paths': str(data_file)} for e in entries],
        )
